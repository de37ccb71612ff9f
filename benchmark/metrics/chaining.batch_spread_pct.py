"""How far the chain loop's ms per read spreads over the traced
batches, in %: (q3 - q1) / median, by ``statistics.quantiles``, of each
batch's ``chain_hits`` time (the port's spans grouped by their batch
id) per read. Every batch of a cell holds the same count of reads
(traffic.make_pool), so each holds the traced reads over the batches."""

import statistics


def read(ctx):
    per = {}
    for s in ctx["stats"].get("spans", ()):
        if s["name"] == "chain_hits" and s["batch"] is not None:
            per[s["batch"]] = per.get(s["batch"], 0) \
                + s["end_ns"] - s["start_ns"]
    if len(per) < 2 or not ctx["reads"]:
        return None
    reads = ctx["reads"] / len(per)
    q1, q2, q3 = statistics.quantiles([1e-6 * v / reads
                                       for v in per.values()], n=4)
    return None if q2 <= 0 else 100.0 * (q3 - q1) / q2
