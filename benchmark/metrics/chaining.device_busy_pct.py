"""The card's busy share inside the chain loop, in %: the union of the
device spans, clipped to the port's ``chain_hits`` spans, over those
spans' total time. The port stamps its spans with ``time.time_ns()``,
the clock the profiler gives its events, so the two compare directly."""

import bisect


def _union(spans):
    """Sorted disjoint [start_ns, end_ns] covering (start, end, ...)."""
    out = []
    for s, e, *_ in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(ctx):
    chains = [(s["start_ns"], s["end_ns"])
              for s in ctx["stats"].get("spans", ())
              if s["name"] == "chain_hits"]
    total = sum(e - s for s, e in chains)
    if total <= 0 or not ctx["device_spans"]:
        return None
    busy = _union(ctx["device_spans"])
    starts = [s for s, _ in busy]
    cover = 0
    for a, b in chains:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            cover += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
    return 100.0 * cover / total
