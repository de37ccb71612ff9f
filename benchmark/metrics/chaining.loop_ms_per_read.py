"""The chain loop's ms per read: the port's ``chain_hits`` stage, which
ends in a synchronize of the batch's stream, so it holds the loop's
enqueue and the card's drain of it, and not the read gather, the chain
planes' copy to the host or their decode, which ``chaining.ms_per_read``
also holds."""


def read(ctx):
    w = ctx["stats"]["wall_s"].get("chain_hits")
    return None if w is None or not ctx["reads"] else 1e3 * w / ctx["reads"]
