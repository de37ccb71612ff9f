"""The host skeleton's ms per read: the port's ``skeleton_host`` stage
(pipeline/skeleton.py and Aligner._enqueue_parts)."""


def read(ctx):
    w = ctx["stats"]["wall_s"].get("skeleton_host")
    return None if w is None or not ctx["reads"] else 1e3 * w / ctx["reads"]
