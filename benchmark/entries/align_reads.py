"""The window's entry: ``lamsa_tpu_torch.pipeline.aln.align_reads`` over
one batch at a time, each on the heels of the last, through one
prepared ``Aligner``, as ``cli aln`` streams a file.

Entries (and faults.py, which breaks one for the check's own tests) are
the only files of the benchmark that import the port. The harness hands
this one the genome codes and the reads it made, and gets back each
read's SAM lines and the port's stage timers. Set-up builds the index
from the codes with the port's own ``KmerIndex.build`` /
``FmIndex.build``, as ``cli index`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lamsa_tpu_torch import AlignConfig, ScoreParams
from lamsa_tpu_torch.index.fmindex import FmIndex
from lamsa_tpu_torch.index.kmer import KmerIndex
from lamsa_tpu_torch.io.refpack import PackedReference
from lamsa_tpu_torch.io.sam import format_sam_record
from lamsa_tpu_torch.pipeline.aln import Aligner, align_reads
from lamsa_tpu_torch.utils.timers import GLOBAL as STATS


def _amb_runs(codes):
    """(start, length) runs of N, the PackedReference layout."""
    m = np.concatenate([[False], codes >= 4, [False]]).astype(np.int8)
    d = np.diff(m)
    s, e = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
    return np.stack([s, e - s], axis=1).astype(np.int64)


def align_config(section: dict) -> AlignConfig:
    """The configuration's ``align`` section as the port's AlignConfig:
    ``scores`` gives ScoreParams, every other key the AlignConfig field
    of its name (a JSON list a tuple field's tuple). A key that names no
    field raises, so a setting the port does not have is never dropped."""
    fields = {f.name for f in dataclasses.fields(AlignConfig)}
    kw = {}
    for key, value in section.items():
        if key == "scores":
            kw[key] = ScoreParams(**value)
        elif key in fields:
            kw[key] = tuple(value) if isinstance(value, list) else value
        else:
            raise ValueError(f"align.{key} is no field of AlignConfig")
    return AlignConfig(**kw)


class Entry:
    def __init__(self, config: dict, genome, device: str):
        idx = config["index"]
        self.ref = PackedReference(names=list(genome.names),
                                   offsets=genome.offsets,
                                   codes=genome.codes,
                                   amb_runs=_amb_runs(genome.codes))
        if idx["kind"] == "kmer":
            self.index = KmerIndex.build(genome.codes, idx["k"],
                                         idx["max_hits_per_kmer"])
        elif idx["kind"] == "fm":
            self.index = FmIndex.build(genome.codes, idx["sa_rate"])
        else:
            raise ValueError(f"unknown index kind {idx['kind']!r}")
        self.config = align_config(config["align"])
        self.batch = config["batch_reads"]
        self.device = torch.device(device)
        self.aligner = Aligner(self.ref, self.index, self.config,
                               device=self.device)
        self.stats = STATS

    def run(self, batch):
        """SAM records of each read of one batch, in order; returns once
        the device has finished."""
        out = list(align_reads(self.ref, self.index, batch, self.config,
                               batch_size=self.batch, aligner=self.aligner))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    @staticmethod
    def sam_lines(records) -> list[str]:
        return [format_sam_record(r) for r in records]

    def close(self):
        del self.aligner, self.index, self.ref
