"""The benchmark of lamsa_tpu_torch, the PyTorch and CUDA port.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix, per-layer metric, cell or
entry lives in a file of its own that the harness finds by name:

  configs/<config>.json    the genome, index and aligner settings
  traffic/<mix>.json       read lengths, error and SV rates, pool size
  limits/<cell>.json       the limits of the numbers `correct` compares
  metrics/<metric>.py      a reader of one per-layer metric
  entries/<entry>.py       the port's entry the window drives

A cell is added as new files and appended manifest entries alone: its
configuration, traffic mix and limits as files, and one line each in
``configs`` and ``workloads`` that starts with ``, {`` (the lists put
their commas first, so an entry appended touches no line before it).
A per-layer metric with no ``workloads`` list reads in every cell; an
entry takes the configuration's whole ``align`` section.

The yardstick (genome and read generation, the plain reference, the
peaks and trace arithmetic) lives beside them and imports nothing of
the port; only ``entries/`` does.
"""
