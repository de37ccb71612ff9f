"""The two DP fill kernels' share of their roofline, in %.

Work: the band cells the traced window's DP instances need (the port's
``dp_cells_*`` counters), at device.OPS_PER_CELL int32 operations and
device.BYTES_PER_CELL bytes each; the least time is device.fill_bound_s.
Time: the device time of the fill kernels, found by name in the trace.
The row fill (csrc/banded_sw_row.cu) and the antidiagonal fill
(csrc/banded_sw_adiag.cu) are both the template ``kernel<N>``; the
walkers and torch's own kernels have other names."""

import re

FILL = re.compile(r"(^|[\s:])kernel<\d+>")


def read(ctx):
    cells = sum(v for k, v in ctx["stats"]["counters"].items()
                if k.startswith("dp_cells_"))
    t = sum(e - s for s, e, name in ctx["device_spans"]
            if FILL.search(name)) / 1e9
    if not cells or t <= 0:
        return None
    return 100.0 * ctx["device"].fill_bound_s(cells) / t
