# Frozen copy of chip_smoke.py: busy_share (the union of device-event intervals) and the H100 roofline constants (HBM_BYTES_PER_S, INT32_OPS_PER_S, OPS_PER_CELL), with their derivation.
"""The card's peaks and the arithmetic over a profiler trace.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet and the Hopper white
paper), at its full power limit of 700 W: 3.35 TB/s of HBM, and 132
SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7 T int32 operations/s.
A band cell of either DP fill costs OPS_PER_CELL integer operations
(H, E, F, the score and the direction bits). That count is ASSUMED, not
derived from the kernels' instructions: it is the count of the
recurrences' own operations, so a kernel that spends more instructions
per cell reads below 100%, never above.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_CELL = 12
BYTES_PER_CELL = 1      # one direction nibble pair per cell, written once


def fill_bound_s(cells: int) -> float:
    """Least time the card could take for `cells` band cells: the larger
    of their integer operations over the INT32 rate and the direction
    bytes they write over the HBM rate (the windows they read are a few
    bytes per row, left out, which only lowers the bound)."""
    return max(OPS_PER_CELL * cells / INT32_OPS_PER_S,
               BYTES_PER_CELL * cells / HBM_BYTES_PER_S)


def busy_s(spans) -> float:
    """Seconds covered by the union of (start_ns, end_ns, ...) spans."""
    busy, end = 0, float("-inf")
    for s, e, *_ in sorted(spans):
        busy += max(0, e - max(s, end))
        end = max(end, e)
    return busy / 1e9


def idle_gaps(spans, t0, t1):
    """[(start_ns, end_ns)] of the window [t0, t1] no device span
    covers."""
    gaps, cur = [], t0
    for s, e, *_ in sorted(spans):
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        gaps.append((cur, t1))
    return [(a, b) for a, b in gaps if b > a]


def gaps_by_stage(gaps, stages):
    """Idle seconds summed by the innermost host stage (name, start_ns,
    end_ns) open at each gap's midpoint, the one opened last; "no
    stage" where none is open. One sweep over the sorted points."""
    pts = [(s, 0, k) for k, (_n, s, _e) in enumerate(stages)]
    pts += [(e, 2, k) for k, (_n, _s, e) in enumerate(stages)]
    pts += [((a + b) // 2, 1, k) for k, (a, b) in enumerate(gaps)]
    pts.sort()
    open_: dict[int, tuple] = {}
    out: dict[str, float] = {}
    for _t, kind, k in pts:
        if kind == 0:
            open_[k] = (stages[k][1], stages[k][0])
        elif kind == 2:
            open_.pop(k, None)
        else:
            name = max(open_.values())[1] if open_ else "no stage"
            a, b = gaps[k]
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])


def top_ops(spans, n=10):
    """[(name, seconds)] of the device operations that took most time."""
    by: dict[str, float] = {}
    for s, e, name in spans:
        by[name] = by.get(name, 0.0) + (e - s) / 1e9
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]
