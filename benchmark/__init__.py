"""The benchmark of lamsa_tpu_torch, the PyTorch and CUDA port.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix, per-layer metric, cell or
entry lives in a file of its own that the harness finds by name:

  configs/<config>.json    the genome, index and aligner settings
  traffic/<mix>.json       read lengths, error and SV rates, pool size
  limits/<cell>.json       the limits of the numbers `correct` compares
  metrics/<metric>.py      a reader of one per-layer metric
  entries/<entry>.py       the port's entry the window drives

The yardstick (genome and read generation, the plain reference, the
peaks and trace arithmetic) lives beside them and imports nothing of
the port; only ``entries/`` does.
"""
