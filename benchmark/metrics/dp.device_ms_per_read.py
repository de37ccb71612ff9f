"""The DP chunks' stream ms per read: the sum of the port's
``device_s`` entries ``dp_{M}x{W}``, each chunk's time on its stream
from a CUDA event recorded before its first launch to the one after its
last (pipeline/extend.py), where ``dp.ms_per_read`` is the host's."""


def read(ctx):
    d = {k: v for k, v in ctx["stats"].get("device_s", {}).items()
         if k.startswith("dp_")}
    return None if not d or not ctx["reads"] \
        else 1e3 * sum(d.values()) / ctx["reads"]
