"""Data parallelism over a device list (lamsa_tpu_torch/parallel/mesh.py)
on CPU entries: the Aligner over a mesh gives SAM byte-identical to one
device on the k-mer, FM and length-skew worlds of tests/test_parallel.py
and on a high-error world whose adaptive re-seed runs; the step
functions equal the JAX package's on __graft_entry__'s tiny problem; the
in-flight budget reads its environment variables and divides per entry."""

import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import _tiny_problem
from lamsa_tpu import sim
from lamsa_tpu.config import AlignConfig, ScoreParams
from lamsa_tpu.index.fmindex import FmIndex
from lamsa_tpu.index.kmer import KmerIndex
from lamsa_tpu.io.fasta import encode_seq
from lamsa_tpu.io.refpack import PackedReference
from lamsa_tpu.io.sam import format_sam_record as jax_format
from lamsa_tpu.parallel import mesh as jmesh
from lamsa_tpu.pipeline.aln import Aligner as JaxAligner
from lamsa_tpu_torch.io.sam import format_sam_record
from lamsa_tpu_torch.ops.testing import port_world
from lamsa_tpu_torch.parallel import mesh as pmesh
from lamsa_tpu_torch.pipeline import extend
from lamsa_tpu_torch.pipeline.aln import Aligner
from lamsa_tpu_torch.utils.timers import GLOBAL as STATS

torch.set_num_threads(1)

CFG = AlignConfig(scores=ScoreParams(match=1, mismatch=3, gap_open=2,
                                     gap_ext=1), seed_step=10)


def _ref(genome):
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    return PackedReference(names=["chr1"],
                           offsets=np.array([0, len(codes)], np.int64),
                           codes=codes, amb_runs=np.zeros((0, 2), np.int64))


def _sam(out, fmt=format_sam_record):
    return [fmt(r) for recs in out for r in recs]


def _mesh_equals_one(ref, idx, cfg, reads, n, jax_too=False):
    """SAM over n CPU entries == one device (== the JAX CPU engine)."""
    world = port_world(ref, idx, cfg)
    one = _sam(Aligner(*world, device="cpu").align_batch(reads))
    STATS.reset()
    got = _sam(Aligner(*world, mesh=["cpu"] * n).align_batch(reads))
    per_entry = {k: v for k, v in STATS.counters.items()
                 if k.startswith("dp_instances_entry")}
    assert got == one
    assert len(one) >= len(reads)
    assert len(per_entry) == n         # every entry ran DP instances
    if jax_too:
        assert got == _sam(JaxAligner(ref, idx, cfg).align_batch(reads),
                           jax_format)
    return got


def test_make_mesh_shard_and_replicate():
    mesh = pmesh.make_mesh(["cpu"] * 8)
    assert mesh == (torch.device("cpu"),) * 8
    assert pmesh.make_mesh(["cuda"]) == (torch.device("cuda", 0),)
    x = np.arange(32 * 4, dtype=np.int32).reshape(32, 4)
    (xs,) = pmesh.shard_batch(mesh, x)
    assert {tuple(b.shape) for b in xs} == {(4, 4)}
    assert torch.equal(torch.cat(xs), torch.from_numpy(x))
    (r,) = pmesh.replicate(mesh, x)
    assert all(t is r[0] for t in r)   # one copy per distinct device
    assert pmesh.row_blocks(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert pmesh.row_blocks(2, 3) == [(0, 1), (1, 2), (2, 2)]


def test_production_aligner_mesh_byte_identical():
    rng = np.random.default_rng(17)
    genome = sim.random_genome(rng, 60000)
    ref = _ref(genome)
    reads = sim.simulate_reads(rng, genome, 24, read_len=(500, 2000),
                               sv_fraction=0.3)
    _mesh_equals_one(ref, KmerIndex.build(ref.codes, 13), CFG, reads, 4,
                     jax_too=True)


def test_production_aligner_mesh_fm_backend_byte_identical():
    rng = np.random.default_rng(23)
    genome = sim.random_genome(rng, 60000)
    ref = _ref(genome)
    reads = sim.simulate_reads(rng, genome, 24, read_len=(500, 2000),
                               sv_fraction=0.3)
    _mesh_equals_one(ref, FmIndex.build(ref.codes, sa_rate=4), CFG, reads,
                     3)


def test_mesh_length_skew_byte_identical():
    """One 8 kb read among 500-700 bp reads over 8 entries: the entry
    holding it does most of the DP; SAM stays identical."""
    rng = np.random.default_rng(31)
    genome = sim.random_genome(rng, 120000)
    ref = _ref(genome)
    short = sim.simulate_reads(rng, genome, 15, read_len=(500, 700),
                               sub=0.02, ins=0.04, dele=0.04)
    big = sim.simulate_reads(np.random.default_rng(9), genome, 1,
                             read_len=(8000, 8100), sub=0.02, ins=0.04,
                             dele=0.04)
    _mesh_equals_one(ref, KmerIndex.build(ref.codes, 13), CFG,
                     list(big) + list(short), 8)


def test_mesh_adaptive_reseed_sub_batches(monkeypatch):
    """25% error: sparse reads re-seed in retry sub-batches, formed as
    on one device (a small element budget makes several) and only then
    split over the entries; SAM equals one device and the JAX engine."""
    from lamsa_tpu.config import preset
    from lamsa_tpu_torch.pipeline import aln as aln_mod
    rng = np.random.default_rng(77)
    genome = sim.random_genome(rng, 200000)
    ref = _ref(genome)
    reads = sim.simulate_reads(rng, genome, 12, read_len=(800, 2000),
                               sub=0.13, ins=0.06, dele=0.06,
                               name_prefix="e25")
    monkeypatch.setattr(aln_mod, "_RETRY_BUDGET_ELEMS", 30_000)
    _mesh_equals_one(ref, KmerIndex.build(ref.codes, 13), preset("pacbio"),
                     reads, 3, jax_too=True)
    assert STATS.counters.get("seed_densified_reads", 0) > 1


@pytest.fixture(scope="module")
def tiny():
    batch, index, dp, cfg = _tiny_problem(B=16, L=256, seed=3)
    jout = {}
    for n in (8, 1):
        mesh = jmesh.make_mesh(jax.devices()[:n])
        jout[n] = jax.tree.map(np.asarray, jmesh.full_align_step(
            mesh, batch, index, dp, cfg))
    return batch, index, dp, cfg, jout


@pytest.mark.parametrize("shard_index", [False, True])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_full_align_step_matches_jax(tiny, n, shard_index):
    batch, index, dp, cfg, jout = tiny
    from lamsa_tpu_torch.config import AlignConfig as PortConfig
    out = pmesh.full_align_step(pmesh.make_mesh(["cpu"] * n), batch, index,
                                dp, PortConfig(seed_step=10),
                                shard_index=shard_index)
    want = jout[8]
    assert want["chain"]["valid"].any()
    for name in ("qpos", "rpos", "strand", "valid", "f", "pred"):
        np.testing.assert_array_equal(
            out["chain"][name].numpy(),
            want["chain"][name].astype(out["chain"][name].numpy().dtype),
            err_msg=name)
    for name in ("global_score", "te_score", "te_d", "best"):
        np.testing.assert_array_equal(out["dp"][name].numpy(),
                                      want["dp"][name], err_msg=name)
    assert (out["dp"]["global_score"] >= 0).all()
    np.testing.assert_array_equal(jout[1]["dp"]["global_score"],
                                  want["dp"]["global_score"])


def test_step_functions_match_jax_on_one_device():
    """seed_chain_step and banded_dp_step, the pieces __graft_entry__'s
    entry() drives, equal the JAX package's on _tiny_problem()."""
    batch, index, dp, cfg = _tiny_problem()
    kw = dict(k=index["k"], cands_per_seed=cfg.max_cands_per_seed,
              max_hits=cfg.max_hits_per_read, weight=index["k"],
              lookback=cfg.chain_lookback, max_dist=cfg.chain_max_dist,
              diag_slack=cfg.chain_diag_slack)
    ix = [index["grid"], index["keys"], index["starts"], index["counts"],
          index["positions"]]
    want = jmesh.seed_chain_step(batch["codes"], batch["len"], *ix, **kw)
    t = torch.from_numpy
    got = pmesh.seed_chain_step(
        t(batch["codes"]), t(batch["len"]), t(ix[0].astype(np.int64)),
        t(ix[1].astype(np.int64)), t(ix[2]), t(ix[3]),
        t(ix[4].astype(np.int64)), **kw)
    for name in ("f", "pred", "qpos", "rpos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    s = cfg.scores
    sk = dict(match=s.match, mismatch=s.mismatch, gapo=s.gap_open,
              gape=s.gap_ext)
    args = [dp[n] for n in ("q", "t_win", "m_len", "n_len", "lo")]
    want = jmesh.banded_dp_step(*args, **sk)
    got = pmesh.banded_dp_step(*(t(a) for a in args), **sk)
    for name in ("global_score", "te_score", "te_d", "best"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


def test_inflight_budget_environment(monkeypatch):
    """LAMSA_INFLIGHT_BUDGET overrides the budget, LAMSA_INFLIGHT_FRACTION
    sets its share of free device memory (as lamsa_tpu/pipeline/aln.py
    reads them); under a mesh each chunk's estimate divides by the
    entry count."""
    codes = np.random.default_rng(2).integers(0, 4, 4000).astype(np.uint8)
    from lamsa_tpu_torch.index.kmer import KmerIndex as PortKmer
    from lamsa_tpu_torch.io.refpack import PackedReference as PortRef
    ref = PortRef(names=["c"], offsets=np.array([0, 4000]), codes=codes,
                  amb_runs=np.zeros((0, 2), np.int64))
    a = Aligner(ref, PortKmer.build(codes, 13), device="cpu")
    resident = sum(t.nbytes for t in a._state.values())
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (0, (8 << 30) + resident))
    monkeypatch.delenv("LAMSA_INFLIGHT_BUDGET", raising=False)
    monkeypatch.delenv("LAMSA_INFLIGHT_FRACTION", raising=False)
    assert a._compute_inflight_budget() == int((8 << 30) * 0.6)
    monkeypatch.setenv("LAMSA_INFLIGHT_FRACTION", "0.25")
    assert a._compute_inflight_budget() == 2 << 30
    monkeypatch.setenv("LAMSA_INFLIGHT_BUDGET", "3e9")
    assert a._compute_inflight_budget() == 3_000_000_000

    taken = []
    monkeypatch.setattr(extend._LIMITER, "acquire",
                        lambda nbytes, budget: taken.append(nbytes))
    monkeypatch.setattr(extend._LIMITER, "release", lambda nbytes: None)
    for mesh in (None, ("cpu",) * 4):
        b = extend.DpBatcher(ScoreParams(), None, None, inflight_budget=1,
                             mesh=mesh)
        futs = []
        b._launch(lambda: ({}, 1024, 256, [], True), 1024, 256, True, futs)
        futs[0].result()              # a launch with no parts to collect
    full = extend._chunk_inflight_bytes(1024, 256, True)
    assert taken == [full, full // 4]


def test_inflight_budget_reads_the_entries_own_cards(monkeypatch):
    """The in-flight budget asks each card the entries run on for its
    memory (cuda:1 for an Aligner on cuda:1, both cards under a two-card
    mesh) and takes the tightest, less that card's resident tensors."""
    codes = np.random.default_rng(2).integers(0, 4, 4000).astype(np.uint8)
    from lamsa_tpu_torch.index.kmer import KmerIndex as PortKmer
    from lamsa_tpu_torch.io.refpack import PackedReference as PortRef
    ref = PortRef(names=["c"], offsets=np.array([0, 4000]), codes=codes,
                  amb_runs=np.zeros((0, 2), np.int64))
    a = Aligner(ref, PortKmer.build(codes, 13), device="cpu")
    st = a._state
    resident = sum(t.nbytes for t in st.values())
    total = {0: 8 << 30, 1: 4 << 30}
    asked = []

    def mem_get_info(dev=None):
        asked.append(torch.device(dev))
        return 0, total[torch.device(dev).index]

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.delenv("LAMSA_INFLIGHT_BUDGET", raising=False)
    monkeypatch.delenv("LAMSA_INFLIGHT_FRACTION", raising=False)
    card = [torch.device("cuda", i) for i in (0, 1)]
    for states, want in (({card[1]: st}, 4 << 30),
                         ({card[0]: st}, 8 << 30),
                         ({card[0]: st, card[1]: st}, 4 << 30)):
        asked.clear()
        a._states = states
        a.device = next(iter(states))
        assert a._compute_inflight_budget() == int((want - resident) * 0.6)
        assert asked == list(states)
