"""Seeding's host-clock ms per read: the port's ``seed_hits`` stage,
which ends in a synchronize of the batch's stream (pipeline/aln.py
_seed_chain_packed), so it holds the device's seeding time."""


def read(ctx):
    w = ctx["stats"]["wall_s"].get("seed_hits")
    return None if w is None or not ctx["reads"] else 1e3 * w / ctx["reads"]
