"""Finalize's ms per read: the port's ``finalize_host`` stage (native
compact decode, CIGAR stitching, MAPQ, SAM records)."""


def read(ctx):
    w = ctx["stats"]["wall_s"].get("finalize_host")
    return None if w is None or not ctx["reads"] else 1e3 * w / ctx["reads"]
