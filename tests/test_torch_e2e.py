"""End to end: the PyTorch port's Aligner on the CPU (the kernels' plain
versions) against the JAX package's Aligner on its CPU engine. SAM must
be byte-identical (format_sam_record) on the tests/test_e2e.py worlds:
noisy reads, SV reads, an inversion, 25% error (adaptive re-seed and
merge-rechain fire), and a repeat with secondary alignments. Global gap
fills ride the antidiagonal pair (its plain versions here) and
extensions the row pair, as in the JAX package. Each side gets its own
reference, index and config, built from the same codes. Also: the
port's align_reads equals its align_batch."""

import numpy as np
import torch

from lamsa_tpu import sim
from lamsa_tpu.config import preset
from lamsa_tpu.index.kmer import KmerIndex
from lamsa_tpu.io.fasta import encode_seq
from lamsa_tpu.io.refpack import PackedReference
from lamsa_tpu.io.sam import format_sam_record as jax_format
from lamsa_tpu.pipeline.aln import Aligner as JaxAligner
from lamsa_tpu_torch.io.sam import format_sam_record
from lamsa_tpu_torch.ops.testing import port_world
from lamsa_tpu_torch.pipeline.aln import Aligner, align_reads
from lamsa_tpu_torch.utils.timers import GLOBAL as STATS
from tests.test_e2e import CFG, make_ref

torch.set_num_threads(1)


def _sam(out, fmt=format_sam_record):
    return [fmt(r) for recs in out for r in recs]


def _port_sam(ref, idx, cfg, reads):
    """The port's SAM on its own objects for the JAX side's ref / idx /
    cfg (same codes and values)."""
    return _sam(Aligner(*port_world(ref, idx, cfg), device="cpu")
                .align_batch(reads))


def _same_sam(ref, idx, cfg, reads, gap_fills=True):
    """gap_fills: the world has global gap fills, which must ride the
    antidiagonal pair."""
    want = _sam(JaxAligner(ref, idx, cfg).align_batch(reads), jax_format)
    STATS.reset()
    got = _port_sam(ref, idx, cfg, reads)
    assert (STATS.counters.get("dp_adiag_instances", 0) > 0) == gap_fills
    assert len(got) == len(want) >= len(reads)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"record {i}:\n{g}\n{w}"
    return got


def test_noisy_and_sv_reads_sam_identical():
    rng = np.random.default_rng(42)
    genome, ref, idx = make_ref(rng, 100000)
    noisy = sim.simulate_reads(rng, genome, 20, read_len=(500, 3000),
                               sub=0.01, ins=0.05, dele=0.04,
                               name_prefix="noisy")
    sv = sim.simulate_reads(rng, genome, 16, read_len=(1200, 2400),
                            sub=0.01, ins=0.04, dele=0.03,
                            sv_fraction=1.0, name_prefix="sv")
    _same_sam(ref, idx, CFG, noisy)
    sam = _same_sam(ref, idx, CFG, sv)
    assert sum("SA:Z:" in s for s in sam) >= 8      # split alignments


def test_inversion_sam_identical():
    rng = np.random.default_rng(42)
    genome, ref, idx = make_ref(rng, 100000)
    g = genome[0].seq
    s, third = 20000, 500
    read = sim.FastxRecord(
        name=f"inv|chr1:{s}-{s+third}:+:0-{third};"
             f"chr1:{s+third}-{s+2*third}:-:{third}-{2*third};"
             f"chr1:{s+2*third}-{s+3*third}:+:{2*third}-{3*third}",
        seq=g[s:s + third] + sim._revcomp(g[s + third:s + 2 * third])
        + g[s + 2 * third:s + 3 * third])
    # three exact segments: extensions only, no gap fill
    sam = _same_sam(ref, idx, CFG, [read], gap_fills=False)
    assert any("sv:Z:" in r and "inversion" in r for r in sam)


def test_high_error_adaptive_reseed_sam_identical():
    """25% total error: the adaptive half-step re-seed and the union
    merge + re-chain fire, and SAM stays identical."""
    rng = np.random.default_rng(77)
    genome, ref, idx = make_ref(rng, 1_000_000)
    reads = sim.simulate_reads(rng, genome, 24, read_len=(800, 3000),
                               sub=0.13, ins=0.06, dele=0.06,
                               sv_fraction=0.2, name_prefix="e25")
    cfg = preset("pacbio")
    want = _sam(JaxAligner(ref, idx, cfg).align_batch(reads), jax_format)
    STATS.reset()
    got = _port_sam(ref, idx, cfg, reads)
    assert STATS.counters.get("seed_densified_reads", 0) > 0
    assert STATS.counters.get("dp_adiag_instances", 0) > 0
    assert got == want


def test_repeat_secondary_sam_identical():
    rng2 = np.random.default_rng(77)
    core = sim.random_genome(rng2, 30000)[0].seq
    seq = core + core[5000:6000] + core[:2000]   # dup of a 1kb block
    codes = np.frombuffer(encode_seq(seq), np.uint8)
    ref = PackedReference(names=["rep"],
                          offsets=np.array([0, len(codes)], np.int64),
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    idx = KmerIndex.build(codes, 13)
    reads = [sim.FastxRecord(name="rep|rep:5200-5800:+:0-600",
                             seq=core[5200:5800])]
    reads += sim.simulate_reads(rng2, [sim.FastxRecord(name="rep", seq=seq)],
                                6, read_len=(400, 1500), sub=0.02,
                                ins=0.03, dele=0.03)
    sam = _same_sam(ref, idx, CFG.replace(report_secondary=True), reads)
    assert any(int(s.split("\t")[1]) & 0x100 for s in sam)


def test_align_reads_equals_align_batch():
    rng = np.random.default_rng(5)
    genome, ref, idx = make_ref(rng, 60000)
    reads = sim.simulate_reads(rng, genome, 12, read_len=(300, 1500),
                               sub=0.02, ins=0.03, dele=0.03,
                               sv_fraction=0.2, name_prefix="pipe")
    ref, idx, cfg = port_world(ref, idx, CFG)
    aligner = Aligner(ref, idx, cfg, device="cpu")
    whole = _sam(aligner.align_batch(reads))
    streamed = _sam(align_reads(ref, idx, reads, cfg, batch_size=5,
                                aligner=aligner))
    assert streamed == whole


def test_hifi_preset_sam_identical():
    """preset("hifi") (the default scores and seeding) end to end:
    low-error reads (0.2% sub / 0.3% ins / 0.3% del) and SV reads."""
    rng = np.random.default_rng(7)
    genome, ref, idx = make_ref(rng, 100000)
    low = sim.simulate_reads(rng, genome, 12, read_len=(1000, 3000),
                             sub=0.002, ins=0.003, dele=0.003,
                             name_prefix="hifi")
    sv = sim.simulate_reads(rng, genome, 10, read_len=(1500, 3000),
                            sub=0.002, ins=0.003, dele=0.003,
                            sv_fraction=1.0, name_prefix="hifisv")
    cfg = preset("hifi")
    _same_sam(ref, idx, cfg, low)
    sam = _same_sam(ref, idx, cfg, sv)
    assert sum("SA:Z:" in s for s in sam) >= 4      # split alignments


def test_threads_four_sam_identical():
    """-t 4 (AlignConfig.threads = 4: finalize on a pool of four threads)
    on tests/test_e2e.py's 100 kb world with noisy and SV reads: SAM
    equals threads = 1 and the JAX Aligner at threads = 4."""
    rng = np.random.default_rng(42)
    genome, ref, idx = make_ref(rng, 100000)
    reads = sim.simulate_reads(rng, genome, 12, read_len=(500, 3000),
                               sub=0.01, ins=0.05, dele=0.04,
                               name_prefix="t4noisy") \
        + sim.simulate_reads(rng, genome, 12, read_len=(1200, 2400),
                             sub=0.01, ins=0.04, dele=0.03,
                             sv_fraction=1.0, name_prefix="t4sv")
    cfg4 = CFG.replace(threads=4)
    sam4 = _same_sam(ref, idx, cfg4, reads)
    assert _port_sam(ref, idx, CFG, reads) == sam4
    assert sum("SA:Z:" in s for s in sam4) >= 6     # split alignments
