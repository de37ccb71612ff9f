"""Copies between the host and a card, counted.

Every copy the port makes between host memory and a CUDA card goes
through ``to_device`` or ``to_host``, which add to the recorder's
counters (utils/timers.py): ``h2d_bytes``, ``d2h_bytes`` and
``d2h_copies``. A copy that stays on the CPU counts nothing.
"""

from __future__ import annotations

from lamsa_tpu_torch.utils.timers import GLOBAL as STATS


def to_device(t, dev):
    """Host tensor ``t`` on ``dev``; its bytes count as ``h2d_bytes``
    when ``dev`` is a card."""
    out = t.to(dev)
    if out.device.type == "cuda" and t.device.type == "cpu":
        STATS.count("h2d_bytes", t.nbytes)
    return out


def to_host(t):
    """Tensor ``t`` as a host numpy array; from a card it counts as one
    of ``d2h_copies`` and its bytes as ``d2h_bytes``."""
    if t.device.type == "cuda":
        STATS.count("d2h_bytes", t.nbytes)
        STATS.count("d2h_copies")
    return t.cpu().numpy()
