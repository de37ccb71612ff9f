"""Repeat-family validation world: recall and MAPQ calibration.

Counterpart of ``tools/repeat_bench.py`` on this package. Every other
world the port runs is an IID random genome; real genomes are about half
repeats, and tandem arrays, dispersed families and segmental
duplications are what stress chain selection, the candidate cap and its
rotation, the hit budget and MAPQ. This tool builds
``sim.repeat_genome`` (about 50% repetitive), simulates CLR reads over
it, and reports:
  * part recall / read accuracy (``eval.evaluate``; truth is the SAMPLED
    copy, so mapping a read to another copy of its family is wrong);
  * MAPQ calibration: per threshold t, the fraction of records at
    MAPQ >= t whose position is wrong (the number a variant caller bets
    on).
The table and the final JSON line are the JAX tool's, key for key.

Run: python -m lamsa_tpu_torch.tools.repeat_bench [--device cuda|cpu]
     [n_reads] [genome_mb]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

SEED = 20260821             # the genome
READS_SEED = 3
K = 13
BATCH = 128
READ_LEN = (1000, 8000)
THRESHOLDS = (0, 10, 20, 30, 40, 50)


def mapq_calibration(out, reads, slack=200):
    """Per-record correctness against truth: a mapped record is correct
    if a truth part on the same strand overlaps its reference interval
    by >= 50% of the record's span. Returns a list of (mapq, correct)."""
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.eval import _rec_interval
    from lamsa_tpu_torch.io.sam import (FLAG_REVERSE, FLAG_SECONDARY,
                                        FLAG_UNMAPPED)
    pairs = []
    for read, recs in zip(reads, out):
        truth = sim.parse_truth(read.name)
        for rec in recs:
            if rec.flag & (FLAG_UNMAPPED | FLAG_SECONDARY):
                continue
            s, e = _rec_interval(rec)
            ok = False
            for p in truth:
                if bool(rec.flag & FLAG_REVERSE) != (p.strand == "-"):
                    continue
                inter = min(e, p.ref_end + slack) - max(s, p.ref_start
                                                        - slack)
                if inter >= 0.5 * (e - s):
                    ok = True
                    break
            pairs.append((rec.mapq, ok))
    return pairs


def repeat_world(mb, n_reads, read_len=READ_LEN):
    """The tool's world: a ``mb`` Mb repeat genome (seed SEED), its k = 13
    index, ``preset("pacbio")`` and n_reads CLR reads of ``read_len`` at
    2% sub / 4% ins / 4% del with 10% SV reads (seed READS_SEED).
    Returns (genome, ref, index, config, reads)."""
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.config import preset
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.io.refpack import PackedReference

    genome = sim.repeat_genome(np.random.default_rng(SEED), int(mb * 1e6))
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    ref = PackedReference(names=[genome[0].name],
                          offsets=np.array([0, len(codes)], np.int64),
                          codes=codes,
                          amb_runs=np.zeros((0, 2), np.int64))
    idx = KmerIndex.build(codes, K)
    reads = sim.simulate_reads(np.random.default_rng(READS_SEED), genome,
                               n_reads, read_len=read_len, sub=0.02,
                               ins=0.04, dele=0.04, sv_fraction=0.1)
    return genome, ref, idx, preset("pacbio"), reads


def align(aligner, reads, batch=BATCH):
    """SAM records per read, BATCH reads per align_batch call."""
    return [r for i in range(0, len(reads), batch)
            for r in aligner.align_batch(reads[i:i + batch])]


def calibration(pairs, thresholds=THRESHOLDS):
    """(t, records at MAPQ >= t, wrong among them, error rate) per t."""
    rows = []
    for t in thresholds:
        sel = [ok for m, ok in pairs if m >= t]
        wrong = sum(1 for ok in sel if not ok)
        rows.append((t, len(sel), wrong, wrong / max(len(sel), 1)))
    return rows


def report(out, reads, st):
    """Print the JAX tool's MAPQ table and return its JSON object (st:
    ``eval.evaluate`` of the records)."""
    pairs = mapq_calibration(out, reads)
    print(f"{'mapq>=':>8s} {'records':>8s} {'wrong':>6s} {'err%':>7s}")
    for t, n, wrong, err in calibration(pairs):
        print(f"{t:>8d} {n:>8d} {wrong:>6d} {100*err:>6.2f}%")
    n30 = [(m, ok) for m, ok in pairs if m >= 30]
    return {
        "metric": "repeat_world_mapq30_err",
        "value": round(sum(1 for _, ok in n30 if not ok)
                       / max(len(n30), 1), 5),
        "part_recall": round(st.part_recall, 4),
        "read_accuracy": round(st.read_accuracy, 4),
        "n_records_mapq30": len(n30),
    }


def run(n_reads=300, mb=5.0, device="cuda"):
    """Build the world, align it on ``device``, print the table and the
    JSON line. Returns a dict: the JSON object ("result"), the records
    ("out"), the reads, the world (genome, ref, index, config) and the
    reads/s of the alignment."""
    from lamsa_tpu_torch.eval import evaluate
    from lamsa_tpu_torch.pipeline.aln import Aligner

    t0 = time.time()
    genome, ref, idx, cfg, reads = repeat_world(mb, n_reads)
    print(f"[repeat_bench] {mb} Mb repeat genome built "
          f"({time.time()-t0:.0f}s)", file=sys.stderr)
    a = Aligner(ref, idx, cfg, device=device)
    t0 = time.time()
    out = align(a, reads)
    rps = len(reads) / (time.time() - t0)
    st = evaluate(out, reads)
    print(f"[repeat_bench] {st.summary()}  ({rps:.1f} reads/s on "
          f"{device})", file=sys.stderr)
    result = report(out, reads, st)
    print(json.dumps(result), flush=True)
    return {"result": result, "out": out, "reads": reads,
            "genome": genome, "ref": ref, "index": idx, "config": cfg,
            "reads_per_s": rps}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=300)
    ap.add_argument("genome_mb", nargs="?", type=float, default=5.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the CUDA kernels) or cpu")
    args = ap.parse_args(argv)
    run(args.n_reads, args.genome_mb, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
