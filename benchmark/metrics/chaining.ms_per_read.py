"""Chaining's host-clock ms per read: ``seed_chain_device`` less
``seed_hits``, the synchronized rest of the seed-chain stage (the chain
loop, the read gather, the chain planes' copy to the host and their
decode), not the enqueue-only ``chain_hits`` stage."""


def read(ctx):
    w = ctx["stats"]["wall_s"]
    if "seed_chain_device" not in w or not ctx["reads"]:
        return None
    return 1e3 * (w["seed_chain_device"] - w.get("seed_hits", 0.0)) \
        / ctx["reads"]
