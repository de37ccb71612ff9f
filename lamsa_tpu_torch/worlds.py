"""The simulated worlds ``chip_smoke.py`` drives, copied from the JAX
package's benchmark scripts so that the port needs nothing outside
itself:

  build_world      bench.py:27-60, the config-1 world (4.6 Mb random
                   genome, KmerIndex k=13, 512 reads of 1-5 kb with SVs)
  reads_10kb       bench.py's 10 kb section (:355-358): 768 reads of
                   9-11 kb on the same genome
  WG_*, sample_reads
                   tools/wholegenome_bench.py's config-4 constants and
                   its 40 kb-window read sampler

Each block is verbatim apart from its import lines and the WG_ prefix
that keeps the two scripts' constants apart.
"""

from __future__ import annotations

import numpy as np

# ---- copied from bench.py:27-60

GENOME_LEN = 4_600_000          # E. coli scale
N_READS = 512
READ_LEN = (1000, 5000)
SEED = 20260817


def build_world():
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.config import AlignConfig, ScoreParams
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.io.refpack import PackedReference

    rng = np.random.default_rng(SEED)
    genome = sim.random_genome(rng, GENOME_LEN)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    offsets = np.zeros(2, np.int64)
    offsets[1] = len(codes)
    ref = PackedReference(names=[genome[0].name], offsets=offsets,
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    idx = KmerIndex.build(codes, 13)
    cfg = AlignConfig(scores=ScoreParams(match=1, mismatch=3, gap_open=2,
                                         gap_ext=1), seed_step=10)
    reads = sim.simulate_reads(rng, genome, N_READS, read_len=READ_LEN,
                               sub=0.01, ins=0.05, dele=0.04,
                               sv_fraction=0.15)
    return genome, ref, idx, cfg, reads


# ---- bench.py's 10 kb section (bench.py:355-358)

N_10KB = 768


def reads_10kb(genome):
    from lamsa_tpu_torch import sim
    rng10 = np.random.default_rng(SEED + 1)
    return sim.simulate_reads(rng10, genome, N_10KB,
                              read_len=(9000, 11000), sub=0.02,
                              ins=0.04, dele=0.04, sv_fraction=0.15)


# ---- copied from tools/wholegenome_bench.py:28-31 and :87-124

WG_GENOME_LEN = 3_100_000_000
WG_N_CHROM = 24
WG_N_RUNS = 200                 # N-runs sprinkled across chromosomes
WG_SEED = 20260820


def sample_reads(ref, n_reads, rng):
    """10 kb reads simulated from genome windows (decoding the whole
    3.1 Gb to str for sim.simulate_reads would need ~25 GB; instead
    sample windows, decode only those, and rebase the truth coords in
    the read names from window-relative to chromosome-relative so
    eval.evaluate works unchanged)."""
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.io.fasta import BASES, FastxRecord
    reads = []
    lut = np.frombuffer("".join(BASES).encode(), np.uint8)
    total = int(ref.total_len)
    offs = np.asarray(ref.offsets)
    WIN = 40_000
    while len(reads) < n_reads:
        w0 = int(rng.integers(0, total - WIN))
        ci = int(np.searchsorted(offs, w0, side="right")) - 1
        if w0 + WIN > offs[ci + 1]:          # window straddles chroms
            continue
        win = ref.codes[w0:w0 + WIN]
        if (win >= 4).mean() > 0.01:
            continue
        seq = lut[np.minimum(win, 4)].tobytes().decode()
        sub = sim.simulate_reads(
            rng, [FastxRecord(name="win", seq=seq)], 1,
            read_len=(9000, 11000), sub=0.02, ins=0.04, dele=0.04,
            sv_fraction=0.15, name_prefix=f"wg{len(reads)}")
        (r,) = sub
        base = w0 - int(offs[ci])
        pref, enc = r.name.split("|", 1)
        parts = []
        for ps in enc.split(";"):
            p = sim.TruthPart.decode(ps)
            p.ref_name = ref.names[ci]
            p.ref_start += base
            p.ref_end += base
            parts.append(p.encode())
        reads.append(FastxRecord(name=pref + "|" + ";".join(parts),
                                 seq=r.seq, qual=r.qual))
    return reads[:n_reads]
