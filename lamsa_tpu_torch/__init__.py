"""lamsa_tpu_torch — the long-read split aligner on PyTorch and CUDA.

A port of the JAX package ``lamsa_tpu`` (which stays the reference) to
PyTorch, with the TPU's Pallas kernels rewritten as CUDA kernels for
Hopper (``csrc/``). Layout mirrors the JAX package: ``ops/`` (kernels
and device helpers), ``pipeline/`` (seeding, DP batching, the aligner),
``cli.py``. The package imports nothing of ``lamsa_tpu``: the host
modules it shares with it (config, io, index, native, sim, eval,
pipeline/skeleton.py) are copies that name their source in their
first line, so index files and SAM stay the JAX package's byte for
byte. ``utils/timers.py`` is the port's own span and counter recorder.

Every entry point takes an explicit torch ``device``: on ``cuda`` the DP
stages launch the kernels, on ``cpu`` they run the kernels' plain torch
versions. Nothing falls back from one device to the other.
"""

# The @PG VN of the SAM header: the JAX package's version
# (lamsa_tpu/__init__.py), so SAM stays byte-identical to its SAM.
__version__ = "0.1.0"

# the JAX package's top-level names (lamsa_tpu/__init__.py)
from lamsa_tpu_torch.config import (  # noqa: F401,E402
    AlignConfig, ScoreParams, preset)
