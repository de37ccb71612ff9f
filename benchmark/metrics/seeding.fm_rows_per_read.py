"""Candidate SA rows per read that FM seeding resolved to genome
positions: the port's counter ``fm_rows_resolved``, the valid hits
seed_hits_fm returns, after the candidate caps, the seg quota and the
cut to the hit budget. It counts hits, not the resolve's work:
``resolve_rows`` walks all max_hits lanes of a read, the invalid ones
masked, so ``seeding.fm_resolve_device_ms_per_read`` follows max_hits.
None where the program has no such counter (the k-mer backend, or a
program without FM counters)."""


def read(ctx):
    n = ctx["stats"]["counters"].get("fm_rows_resolved")
    return None if n is None or not ctx["reads"] else n / ctx["reads"]
