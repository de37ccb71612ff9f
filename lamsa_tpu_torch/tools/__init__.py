"""The JAX package's validation tools (``tools/`` at the repository
root), ported: each module takes its tool's arguments plus ``--device``
(``cuda`` by default, ``cpu`` on request), prints its tool's tables and
final JSON line under the same keys, and uses only this package.

    python -m lamsa_tpu_torch.tools.repeat_bench [--device D] [n_reads] [genome_mb]
    python -m lamsa_tpu_torch.tools.ont_preset_sweep [--device D] [n_reads]
    python -m lamsa_tpu_torch.tools.soak_bench --workdir W [--device D] ...
"""
