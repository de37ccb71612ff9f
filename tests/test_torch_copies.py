"""The port's copies of the JAX package's JAX-free modules give the
originals' results on the same seeded inputs: config presets, FASTA /
FASTQ reading, the packed reference, SAM strings, both index kinds (and
their files, written by either package and read by the other), the
skeleton, the native library, the simulator, the evaluator and the
worlds chip_smoke.py drives. Each family is one parametrised test."""

import dataclasses
import gzip
import os

import numpy as np
import pytest

import bench
from lamsa_tpu import config as j_config
from lamsa_tpu import eval as j_eval
from lamsa_tpu import native as j_native
from lamsa_tpu import sim as j_sim
from lamsa_tpu.index import fmindex as j_fm
from lamsa_tpu.index import kmer as j_kmer
from lamsa_tpu.io import fasta as j_fasta
from lamsa_tpu.io import refpack as j_refpack
from lamsa_tpu.io import sam as j_sam
from lamsa_tpu.pipeline import skeleton as j_skel
from lamsa_tpu_torch import config as p_config
from lamsa_tpu_torch import eval as p_eval
from lamsa_tpu_torch import native as p_native
from lamsa_tpu_torch import sim as p_sim
from lamsa_tpu_torch import worlds
from lamsa_tpu_torch.index import fmindex as p_fm
from lamsa_tpu_torch.index import kmer as p_kmer
from lamsa_tpu_torch.io import fasta as p_fasta
from lamsa_tpu_torch.io import refpack as p_refpack
from lamsa_tpu_torch.io import sam as p_sam
from lamsa_tpu_torch.pipeline import skeleton as p_skel


def same(a, b):
    """Deep equality of the two packages' values: dataclasses field by
    field (their classes differ), arrays by dtype, shape and value."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__
        return all(same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape \
            and bool(np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) \
            and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _genome_codes(rng, n, n_runs=6):
    codes = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(n_runs):
        p = int(rng.integers(0, n - 400))
        codes[p:p + int(rng.integers(20, 400))] = 4
    return codes


# ------------------------------------------------------------------ config

PRESETS = ["pacbio", "pb", "clr", "ont", "ont2d", "nanopore", "default",
           "hifi", "ccs"]


@pytest.mark.parametrize("name", PRESETS + ["AlignConfig()", "replace"])
def test_config_copy(name):
    if name == "AlignConfig()":
        assert same(p_config.AlignConfig(), j_config.AlignConfig())
    elif name == "replace":
        kw = dict(seed_step=7, band_width=128, report_secondary=True)
        assert same(p_config.preset("ont").replace(**kw),
                    j_config.preset("ont").replace(**kw))
        assert p_config.ScoreParams().as_tuple() \
            == j_config.ScoreParams().as_tuple()
    else:
        assert same(p_config.preset(name), j_config.preset(name))


# ------------------------------------------------------------------- fasta

@pytest.mark.parametrize("case", ["encode_seq", "fasta", "fastq",
                                  "fastq_gz"])
def test_fasta_copy(case, tmp_path):
    rng = np.random.default_rng(11)
    alphabet = np.frombuffer(b"ACGTNacgtnRYKM", np.uint8)
    seqs = [alphabet[rng.integers(0, len(alphabet), int(L))]
            .tobytes().decode() for L in rng.integers(50, 400, 5)]
    if case == "encode_seq":
        for s in seqs:
            assert p_fasta.encode_seq(s) == j_fasta.encode_seq(s)
            assert p_fasta.encode_seq(s.encode()) \
                == j_fasta.encode_seq(s.encode())
        return
    recs = [j_fasta.FastxRecord(name=f"r{i} desc", seq=s,
                                qual="I" * len(s) if case != "fasta"
                                else None)
            for i, s in enumerate(seqs)]
    path = str(tmp_path / ("x.fa" if case == "fasta" else "x.fq"))
    (j_fasta.write_fasta if case == "fasta" else j_fasta.write_fastq)(
        path, recs)
    if case == "fastq_gz":
        with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
            dst.write(src.read())
        path += ".gz"
    assert same(list(p_fasta.read_fastx(path)),
                list(j_fasta.read_fastx(path)))


# ----------------------------------------------------------------- refpack

def _write_multi_fasta(tmp_path, rng):
    recs = []
    for i, n in enumerate((3000, 1700, 5200)):
        codes = _genome_codes(rng, n, n_runs=2)
        recs.append(j_fasta.FastxRecord(
            name=f"chr{i}", seq=j_fasta.decode_seq(codes)))
    path = str(tmp_path / "g.fa")
    j_fasta.write_fasta(path, recs)
    return path


@pytest.mark.parametrize("case", ["from_fasta", "jax_saves_port_loads",
                                  "port_saves_jax_loads"])
def test_refpack_copy(case, tmp_path):
    fa = _write_multi_fasta(tmp_path, np.random.default_rng(12))
    p_ref = p_refpack.PackedReference.from_fasta(fa)
    j_ref = j_refpack.PackedReference.from_fasta(fa)
    d = str(tmp_path / "idx")
    if case == "from_fasta":
        assert same(p_ref, j_ref)
        assert p_ref.global_to_local(4000) == j_ref.global_to_local(4000)
    elif case == "jax_saves_port_loads":
        j_ref.save(d)
        assert same(p_refpack.PackedReference.load(d), j_ref)
    else:
        p_ref.save(d)
        assert same(j_refpack.PackedReference.load(d), p_ref)


# --------------------------------------------------------------------- sam

def _sam_cases(mod):
    runs = np.array([(12 << 4) | mod.OP_S, (300 << 4) | mod.OP_M,
                     (4 << 4) | mod.OP_D, (50 << 4) | mod.OP_M,
                     (2 << 4) | mod.OP_I, (80 << 4) | mod.OP_M],
                    np.uint32)
    return [
        mod.SamRecord(qname="r1", flag=0, rname="chr1", pos=99, mapq=60,
                      cigar=runs, seq="ACGT" * 112, qual=None,
                      tags={"NM": 7, "AS": 401, "MD": "10A5^CG0T3"}),
        mod.SamRecord(qname="r1", flag=mod.FLAG_SUPPLEMENTARY
                      | mod.FLAG_REVERSE, rname="chr2", pos=0, mapq=3,
                      cigar=[(mod.OP_S, 5), (mod.OP_M, 20)], seq="",
                      qual="", tags={"SA": "chr1,100,+,12S300M,60,7;",
                                     "tp": "P", "cm": 0.25, "zz": 1}),
        mod.unmapped_record("r2", "NNNN", "!!!!"),
    ]


@pytest.mark.parametrize("case", ["records", "header", "header_rg",
                                  "cigar_helpers"])
def test_sam_copy(case, tmp_path):
    if case == "records":
        for a, b in zip(_sam_cases(p_sam), _sam_cases(j_sam)):
            assert p_sam.format_sam_record(a) == j_sam.format_sam_record(b)
            assert a.sa_item() == b.sa_item()
        return
    if case == "cigar_helpers":
        runs = _sam_cases(j_sam)[0].cigar
        for f in ("cigar_to_string", "cigar_ref_len", "cigar_query_len",
                  "merge_runs", "cigar_pairs"):
            got = getattr(p_sam, f)(runs)
            want = getattr(j_sam, f)(runs)
            assert same(list(got) if f == "cigar_pairs" else got,
                        list(want) if f == "cigar_pairs" else want), f
        return
    fa = _write_multi_fasta(tmp_path, np.random.default_rng(13))
    ref = j_refpack.PackedReference.from_fasta(fa)
    rg = "grp1" if case == "header_rg" else None
    got = p_sam.sam_header(ref, "aln x.fa y.fq", rg_id=rg)
    assert got == j_sam.sam_header(ref, "aln x.fa y.fq", rg_id=rg)
    assert "@PG\tID:lamsa_tpu\tPN:lamsa_tpu\tVN:0.1.0\t" in got


# ------------------------------------------------------------------ indexes

@pytest.fixture(scope="module")
def genome200k():
    return _genome_codes(np.random.default_rng(14), 200_000, n_runs=12)


@pytest.fixture(scope="module")
def fm_pair(genome200k):
    return (p_fm.FmIndex.build(genome200k),
            j_fm.FmIndex.build(genome200k))


@pytest.mark.parametrize("case", ["kmer_build", "kmer_jax_saves_port_loads",
                                  "kmer_port_saves_jax_loads", "fm_build",
                                  "fm_jax_saves_port_loads",
                                  "fm_port_saves_jax_loads", "auto_kmer"])
def test_index_copy(case, genome200k, fm_pair, tmp_path):
    d = str(tmp_path / "idx")
    if case == "auto_kmer":
        for L in (1000, 4_600_000, 3_100_000_000):
            assert p_kmer.auto_kmer(L) == j_kmer.auto_kmer(L)
        return
    if case.startswith("kmer"):
        p = p_kmer.KmerIndex.build(genome200k, 13, max_hits_per_kmer=8)
        j = j_kmer.KmerIndex.build(genome200k, 13, max_hits_per_kmer=8)
        if case == "kmer_build":
            assert same(p, j)
        elif case == "kmer_jax_saves_port_loads":
            j.save(d)
            assert same(p_kmer.KmerIndex.load(d), j)
        else:
            p.save(d)
            assert same(j_kmer.KmerIndex.load(d), p)
        return
    p, j = fm_pair
    if case == "fm_build":
        assert same(p, j)
        piece = genome200k[5000:5016]
        assert p.backward_search(piece) == j.backward_search(piece)
    elif case == "fm_jax_saves_port_loads":
        j.save(d)
        assert p_fm.FmIndex.exists(d)
        assert same(p_fm.FmIndex.load(d), j)
    else:
        p.save(d)
        assert j_fm.FmIndex.exists(d)
        assert same(j_fm.FmIndex.load(d), p)


# ----------------------------------------------------------------- skeleton

def _chain_arrays(rng, H=96, read_len=3000, k=13):
    """Seeded chain-DP outputs: a few co-linear anchor runs on both
    strands, some overlapping in the read, plus invalid padding."""
    qpos = np.zeros(H, np.int64)
    rpos = np.zeros(H, np.int64)
    strand = np.zeros(H, np.int64)
    valid = np.zeros(H, bool)
    f = np.zeros(H, np.int64)
    pred = np.full(H, -1, np.int64)
    i = 0
    for c in range(int(rng.integers(2, 6))):
        st = int(rng.integers(0, 2))
        q0 = int(rng.integers(0, read_len - 800))
        r0 = int(rng.integers(0, 2_000_000))
        prev = -1
        for n in range(int(rng.integers(2, 12))):
            if i >= H:
                break
            qpos[i] = q0 + 30 * n + int(rng.integers(0, 5))
            rpos[i] = r0 + 30 * n + int(rng.integers(0, 5))
            strand[i], valid[i] = st, True
            f[i] = (n + 1) * k + int(rng.integers(0, 3))
            pred[i] = prev
            prev = i
            i += 1
    return f, pred, qpos, rpos, strand, valid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_skeleton_copy(seed, tmp_path):
    rng = np.random.default_rng(100 + seed)
    fa = _write_multi_fasta(tmp_path, rng)
    ref = j_refpack.PackedReference.from_fasta(fa)
    arrs = _chain_arrays(rng)
    cfg_p = p_config.preset("pacbio").replace(report_secondary=seed % 2 == 1)
    cfg_j = j_config.preset("pacbio").replace(report_secondary=seed % 2 == 1)
    got = p_skel.build_skeleton(*arrs, k=13, read_len=3000, ref=ref,
                                config=cfg_p)
    want = j_skel.build_skeleton(*arrs, k=13, read_len=3000, ref=ref,
                                 config=cfg_j)
    assert same(got, want)
    for part in want.parts:
        assert same(p_skel.anchors_to_blocks(part.anchors, 13),
                    j_skel.anchors_to_blocks(part.anchors, 13))


# ------------------------------------------------------------------- native

def _compact_wires():
    """Compact wires of a chunk of global gap fills (the port's row
    pair on the CPU), one per read strand, as collect_group slices them."""
    import torch

    from lamsa_tpu_torch.ops.dp_chain import dp_tb_gather
    from lamsa_tpu_torch.ops.testing import make_global_chunk
    from lamsa_tpu_torch.ops.wire import compact_words
    M, W = 128, 128
    fw, rw, desc = make_global_chunk(np.random.default_rng(15), M, W, 12, 12)
    wire = dp_tb_gather(*(torch.from_numpy(a) for a in (fw, rw, desc)),
                        M=M, W=W, scores=p_config.ScoreParams(), zdrop=0)
    packed = wire.numpy()
    nw, Ew = M // 32, compact_words(M)
    tail = packed[:, nw + Ew:]
    return (packed[:, :nw], packed[:, nw:nw + Ew], tail[:, 0] & 0xFFFF,
            tail[:, 1] & 0xFFFF, (tail[:, 0] >> 16) & 0xFFFF)


@pytest.mark.parametrize("fn", ["revcomp4", "decode_compact_batch",
                                "banded_sw_tb", "anchors_to_blocks",
                                "backtrack_chains_native",
                                "suffix_array_full", "bwt_from_sa"])
def test_native_copy(fn):
    assert p_native.available() and j_native.available()
    rng = np.random.default_rng(16)
    codes = _genome_codes(rng, 5000, n_runs=3)
    if fn == "revcomp4":
        args, kw = (codes,), {}
    elif fn == "decode_compact_batch":
        args, kw = _compact_wires(), {}
    elif fn == "banded_sw_tb":
        t = rng.integers(0, 4, 300).astype(np.uint8)
        q = np.delete(t, np.arange(100, 140))
        q[::17] = (q[::17] + 1) & 3
        args = (q, t, j_config.ScoreParams(), -80, 47, len(q), len(t))
        kw = {}
    elif fn == "anchors_to_blocks":
        q0 = np.sort(rng.integers(0, 3000, 40))
        args, kw = (np.stack([q0, q0 + 1000 + rng.integers(0, 3, 40)], 1),
                    13), {}
    elif fn == "backtrack_chains_native":
        f, pred, qpos, _rpos, strand, valid = _chain_arrays(rng)
        args = (f, pred, qpos, strand, valid)
        kw = dict(k=13, read_len=3000, min_anchors=2, min_score=26,
                  max_chains=8, max_overlap_frac=0.5, keep_secondaries=3)
    elif fn == "suffix_array_full":
        args, kw = (codes,), {}
    else:
        args, kw = (codes, j_native.suffix_array_full(codes)), {}
    got = getattr(p_native, fn)(*args, **kw)
    want = getattr(j_native, fn)(*args, **kw)
    assert same(got, want)
    if fn == "decode_compact_batch":
        assert sum(c is not None for c in got) >= 6


# ---------------------------------------------------------------- sim, eval

@pytest.mark.parametrize("case", ["random_genome", "simulate_reads",
                                  "simulate_reads_sv", "parse_truth"])
def test_sim_copy(case):
    p_rng, j_rng = np.random.default_rng(17), np.random.default_rng(17)
    p_g = p_sim.random_genome(p_rng, 40_000)
    j_g = j_sim.random_genome(j_rng, 40_000)
    if case == "random_genome":
        assert same(p_g, j_g)
        return
    kw = dict(read_len=(500, 3000), sub=0.02, ins=0.03, dele=0.03,
              sv_fraction=0.6 if case == "simulate_reads_sv" else 0.0)
    p_r = p_sim.simulate_reads(p_rng, p_g, 12, **kw)
    j_r = j_sim.simulate_reads(j_rng, j_g, 12, **kw)
    if case == "parse_truth":
        for a, b in zip(p_r, j_r):
            assert same(p_sim.parse_truth(a.name), j_sim.parse_truth(b.name))
        return
    assert same(p_r, j_r)


def _records_from_truth(mod, sim, reads, rng):
    """SAM records placed at (or near, or away from) each read's truth
    parts, some reads left unmapped."""
    out = []
    for r in reads:
        recs = []
        for t in sim.parse_truth(r.name):
            if rng.random() < 0.15:
                continue
            jit = int(rng.integers(-30, 30)) if rng.random() < 0.8 \
                else 5000
            qs, qe = t.q_start, t.q_end
            cig = [(mod.OP_S, qs), (mod.OP_M, max(1, qe - qs)),
                   (mod.OP_S, max(0, len(r.seq) - qe))]
            flag = mod.FLAG_REVERSE if t.strand == "-" else 0
            recs.append(mod.SamRecord(
                qname=r.name, flag=flag,
                rname=t.ref_name, pos=max(0, t.ref_start + jit), mapq=60,
                cigar=cig, seq=r.seq))
        out.append(recs or [mod.unmapped_record(r.name, r.seq, None)])
    return out


@pytest.mark.parametrize("slack", [200, 20])
def test_eval_copy(slack):
    rng = np.random.default_rng(18)
    genome = j_sim.random_genome(rng, 60_000)
    reads = j_sim.simulate_reads(rng, genome, 30, read_len=(800, 3000),
                                 sv_fraction=0.5)
    p_recs = _records_from_truth(p_sam, p_sim, reads,
                                 np.random.default_rng(19))
    j_recs = _records_from_truth(j_sam, j_sim, reads,
                                 np.random.default_rng(19))
    got = p_eval.evaluate(p_recs, reads, slack=slack)
    want = j_eval.evaluate(j_recs, reads, slack=slack)
    assert same(got, want)
    assert (got.part_recall, got.read_accuracy, got.bp_mean_err,
            got.summary()) == (want.part_recall, want.read_accuracy,
                               want.bp_mean_err, want.summary())
    assert 0 < got.parts_found < got.n_parts


# ------------------------------------------------------------------- worlds

@pytest.mark.parametrize("case", ["build_world", "sample_reads"])
def test_worlds_copy(case):
    if case == "build_world":
        got, want = worlds.build_world(), bench.build_world()
        for a, b in zip(got, want):
            assert same(a, b)
        assert (worlds.GENOME_LEN, worlds.N_READS, worlds.READ_LEN,
                worlds.SEED) == (bench.GENOME_LEN, bench.N_READS,
                                 bench.READ_LEN, bench.SEED)
        return
    from tools import wholegenome_bench as wg
    assert (worlds.WG_SEED, worlds.WG_GENOME_LEN, worlds.WG_N_CHROM,
            worlds.WG_N_RUNS) == (wg.SEED, wg.GENOME_LEN, wg.N_CHROM,
                                  wg.N_RUNS)
    codes = _genome_codes(np.random.default_rng(20), 300_000, n_runs=20)
    ref = j_refpack.PackedReference(
        names=["chr1", "chr2"], offsets=np.array([0, 150_000, 300_000]),
        codes=codes, amb_runs=j_refpack._find_runs(codes >= 4))
    got = worlds.sample_reads(ref, 6, np.random.default_rng(21))
    want = wg.sample_reads(ref, 6, np.random.default_rng(21))
    assert same(got, want)


def test_worlds_10kb_reads_follow_bench():
    """reads_10kb is bench.py's 10 kb read set: the same generator seed
    and read class (bench.py builds it inline, so the recipe is restated
    here with the JAX simulator)."""
    genome = j_sim.random_genome(np.random.default_rng(22), 80_000)
    want = j_sim.simulate_reads(np.random.default_rng(bench.SEED + 1),
                                genome, 768, read_len=(9000, 11000),
                                sub=0.02, ins=0.04, dele=0.04,
                                sv_fraction=0.15)
    assert same(worlds.reads_10kb(genome), want)
    assert os.path.basename(worlds.__file__) == "worlds.py"


# ---------------------------------------------------------------- samcheck

@pytest.fixture(scope="module")
def aligned_world():
    """A clean multi-part batch from the JAX CPU engine
    (tests/test_samcheck.py's mutation world) and the port's reference."""
    from lamsa_tpu.pipeline.aln import Aligner
    from lamsa_tpu_torch.ops.testing import port_world
    from tests.test_e2e import CFG, make_ref
    rng = np.random.default_rng(13)
    genome, ref, idx = make_ref(rng, 120000)
    reads = j_sim.simulate_reads(rng, genome, 8, read_len=(1500, 3000),
                                 sub=0.01, ins=0.03, dele=0.03,
                                 sv_fraction=1.0, name_prefix="m")
    return ref, port_world(ref)[0], Aligner(ref, idx, CFG).align_batch(reads)


def _mutate(recs, case, mod):
    recs = [dataclasses.replace(r, tags=dict(r.tags)) for r in recs]
    if case == "nm":
        recs[0].tags["NM"] += 1
    elif case == "cigar":
        pairs = list(mod.cigar_pairs(recs[0].cigar))
        pairs[0] = (pairs[0][0], pairs[0][1] + 3)
        recs[0].cigar = pairs
    elif case == "sa":
        recs[0].tags["SA"] = "chr_bogus,1,+,10M,0,0;"
    elif case == "primary":
        recs[1].flag &= ~mod.FLAG_SUPPLEMENTARY
    elif case == "bounds":
        recs[0].pos = 10 ** 7
    return recs


@pytest.mark.parametrize("case", ["clean", "nm", "cigar", "sa", "primary",
                                  "bounds"])
def test_samcheck_copy(case, aligned_world):
    """validate_batch gives the same findings on the same records: none
    on the engine's clean batch, the same list on each mutation."""
    from lamsa_tpu.io import samcheck as j_check
    from lamsa_tpu_torch.io import samcheck as p_check
    jref, pref, out = aligned_world
    multi = next(recs for recs in out if len(recs) > 1)
    j_recs = [_mutate(r, case, j_sam) if r is multi else r for r in out]
    p_recs = [[p_sam.SamRecord(**{f.name: getattr(x, f.name) for f in
                                  dataclasses.fields(x)}) for x in r]
              for r in j_recs]
    want = j_check.validate_batch(j_recs, jref)
    assert p_check.validate_batch(p_recs, pref) == want
    assert (want == []) == (case == "clean")


@pytest.mark.parametrize("D", [1, 3, 8])
@pytest.mark.parametrize("k", [13, 16])
def test_shard_kmer_index_copy(D, k):
    from lamsa_tpu.parallel import sharded_index as j_sh
    from lamsa_tpu_torch.parallel import sharded_index as p_sh
    codes = _genome_codes(np.random.default_rng(23), 20_000)
    codes[5000:5040] = 3                    # an all-T run: key 0xFFFFFFFF
    got = p_sh.shard_kmer_index(p_kmer.KmerIndex.build(codes, k), D)
    want = j_sh.shard_kmer_index(j_kmer.KmerIndex.build(codes, k), D)
    assert same(got, want)
    assert same(p_sh._PAD_KEY, j_sh._PAD_KEY)
