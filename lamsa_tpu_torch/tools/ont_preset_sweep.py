"""Candidate ``ont`` presets on the high-error regime.

Counterpart of ``tools/ont_preset_sweep.py`` on this package. ONT
(non-CCS) reads run about 10-25% total error with a higher substitution
share than PacBio CLR (which is indel-dominated); the shared preset
holds recall through about 22% and falls off near 25%. The candidates
densify seeding and/or soften the mismatch penalty; the
``fm+1edit(ont)`` row runs the FM backend under ``preset("ont")``, whose
adaptive re-seed also searches 1-substitution variants of each piece.

Prints the JAX tool's table, part_recall / read_acc and seconds per
(candidate, error profile), then one JSON line with every cell.

Run: python -m lamsa_tpu_torch.tools.ont_preset_sweep [--device cuda|cpu]
     [n_reads]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

SEED = 42                   # the genome
READS_SEED = 7              # every cell's reads
GENOME_LEN = 1_000_000
K = 13

# ONT-profile error mixes: substitution-heavy
PROFILES = {
    "20%": dict(sub=0.10, ins=0.05, dele=0.05),
    "23%": dict(sub=0.12, ins=0.06, dele=0.05),
    "25%": dict(sub=0.13, ins=0.06, dele=0.06),
    "28%": dict(sub=0.15, ins=0.07, dele=0.06),
}


def world(length=GENOME_LEN):
    """The tool's random genome (seed SEED), reference, k = 13 index and
    FM index. Returns (genome, ref, kmer_index, fm_index)."""
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.index.fmindex import FmIndex
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.io.refpack import PackedReference

    genome = sim.random_genome(np.random.default_rng(SEED), length)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    ref = PackedReference(names=[genome[0].name],
                          offsets=np.array([0, len(codes)], np.int64),
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    return genome, ref, KmerIndex.build(codes, K), FmIndex.build(codes)


def candidates(idx, fm):
    """The six candidates: name -> (AlignConfig, index)."""
    from lamsa_tpu_torch.config import ScoreParams, preset
    pb = preset("pacbio")
    mm2 = ScoreParams(match=1, mismatch=2, gap_open=2, gap_ext=1)
    return {
        "pacbio(step10)": (pb, idx),
        "step8": (pb.replace(seed_step=8), idx),
        "step6": (pb.replace(seed_step=6), idx),
        "step8,mm2": (pb.replace(seed_step=8, scores=mm2), idx),
        "step6,mm2": (pb.replace(seed_step=6, scores=mm2), idx),
        "fm+1edit(ont)": (preset("ont"), fm),
    }


def profile_reads(genome, profile, n_reads):
    """One error profile's reads: 1-4 kb, 20% SV reads (seed
    READS_SEED, the same draws for every candidate)."""
    from lamsa_tpu_torch import sim
    return sim.simulate_reads(np.random.default_rng(READS_SEED), genome,
                              n_reads, read_len=(1000, 4000),
                              sv_fraction=0.2, **PROFILES[profile])


def sweep(n_reads=48, device="cuda", keep=()):
    """Every (candidate, profile) cell on ``device``, printing the JAX
    tool's table row by row. Returns (cells, kept, world): cells maps
    candidate -> profile -> {part_recall, read_accuracy, seconds}; kept
    maps each (candidate, profile) in ``keep`` to (reads, records)."""
    from lamsa_tpu_torch.eval import evaluate
    from lamsa_tpu_torch.pipeline.aln import Aligner

    genome, ref, idx, fm = w = world()
    reads = {p: profile_reads(genome, p, n_reads) for p in PROFILES}
    cells, kept = {}, {}
    print(f"{'preset':16s} " + " ".join(f"{p:>16s}" for p in PROFILES))
    for cname, (cfg, index) in candidates(idx, fm).items():
        row, cells[cname] = [], {}
        for pname in PROFILES:
            a = Aligner(ref, index, cfg, device=device)
            t0 = time.time()
            out = a.align_batch(reads[pname])
            secs = time.time() - t0
            st = evaluate(out, reads[pname])
            cells[cname][pname] = {"part_recall": round(st.part_recall, 4),
                                   "read_accuracy": round(
                                       st.read_accuracy, 4),
                                   "seconds": round(secs, 3)}
            if (cname, pname) in keep:
                kept[(cname, pname)] = (reads[pname], out)
            row.append(f"{st.part_recall:.3f}/{st.read_accuracy:.3f}"
                       f" {secs:4.0f}s")
        print(f"{cname:16s} " + " ".join(f"{v:>16s}" for v in row),
              flush=True)
    return cells, kept, w


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=48)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the CUDA kernels) or cpu")
    args = ap.parse_args(argv)
    cells, _, _ = sweep(args.n_reads, args.device)
    print(json.dumps({"metric": "ont_preset_sweep", "n_reads": args.n_reads,
                      "device": args.device, "cells": cells}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
