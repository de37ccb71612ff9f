"""KiB per read the port copied from the card to the host: its
``d2h_bytes`` counter (lamsa_tpu_torch/utils/transfer.py), the chain
planes and the DP chunks' compact wires."""


def read(ctx):
    b = ctx["stats"]["counters"].get("d2h_bytes")
    return None if b is None or not ctx["reads"] \
        else b / 1024 / ctx["reads"]
