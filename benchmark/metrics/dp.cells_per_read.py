"""Band cells per read the DP batcher asked for: the sum of the port's
``dp_cells_{M}x{W}`` counters (rows x band of every instance)."""


def read(ctx):
    cells = sum(v for k, v in ctx["stats"]["counters"].items()
                if k.startswith("dp_cells_"))
    return None if not cells or not ctx["reads"] else cells / ctx["reads"]
