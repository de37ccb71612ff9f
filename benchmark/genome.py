"""The reference genome of a configuration, made from its ``data_seed``.

Random bases (uniform over ACGT) in ``chromosomes`` sequences of
``chromosome_bp`` each, with ``n_runs_per_chromosome`` runs of N (code
4) of ``n_run_bp`` = [lo, hi) bases each, as the config-4 genome of the
JAX package's ``tools/wholegenome_bench.py`` draws them. Both the port
and the reference get these codes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Genome:
    names: list[str]
    offsets: np.ndarray      # int64[S+1], start of each chromosome
    codes: np.ndarray        # uint8[L], 0-3 = ACGT, 4 = N

    def chrom_len(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])


def make_genome(params: dict, rng: np.random.Generator) -> Genome:
    n_chrom = int(params["chromosomes"])
    per = int(params["chromosome_bp"])
    n_runs = int(params.get("n_runs_per_chromosome", 0))
    lo, hi = params.get("n_run_bp", [100, 2000])
    codes = rng.integers(0, 4, n_chrom * per, dtype=np.uint8)
    for c in range(n_chrom):
        base = c * per
        for _ in range(n_runs):
            p = int(rng.integers(0, per - hi))
            codes[base + p:base + p + int(rng.integers(lo, hi))] = 4
    return Genome(names=[f"chr{c + 1}" for c in range(n_chrom)],
                  offsets=np.arange(n_chrom + 1, dtype=np.int64) * per,
                  codes=codes)
