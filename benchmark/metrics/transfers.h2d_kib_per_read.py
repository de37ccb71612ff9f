"""KiB per read the port copied from the host to the card: its
``h2d_bytes`` counter (lamsa_tpu_torch/utils/transfer.py)."""


def read(ctx):
    b = ctx["stats"]["counters"].get("h2d_bytes")
    return None if b is None or not ctx["reads"] \
        else b / 1024 / ctx["reads"]
