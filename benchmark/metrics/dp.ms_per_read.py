"""The DP batcher's ms per read: the port's ``dp_batch`` stage, whose
collect waits on each chunk's event, so it holds the DP's device time."""


def read(ctx):
    w = ctx["stats"]["wall_s"].get("dp_batch")
    return None if w is None or not ctx["reads"] else 1e3 * w / ctx["reads"]
