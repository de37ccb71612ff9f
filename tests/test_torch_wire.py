"""Device data movement of the PyTorch port (lamsa_tpu_torch/ops/wire.py,
ops/dp_chain.py) against the JAX package (lamsa_tpu/ops/banded_sw.py):
packed code words, run and window gathers (both strands, reversed
windows, band heads that run off the reference start), the descriptor
wire, global_lo, extract_scores, and a whole descriptor chunk against
JAX _dp_tb_fused_gather with the Pallas kernels in interpret mode.
Exact equality throughout."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamsa_tpu.ops import banded_sw as jbs
from lamsa_tpu.ops import banded_sw_pallas, traceback_pallas
from lamsa_tpu.pipeline.aln import Aligner as JaxAligner
from lamsa_tpu_torch.config import ScoreParams
from lamsa_tpu_torch.ops import wire
from lamsa_tpu_torch.ops.dp_chain import dp_tb_gather

torch.set_num_threads(1)

S = ScoreParams(match=1, mismatch=3, gap_open=2, gap_ext=1, zdrop=100)


def _t(a, dtype=torch.int64):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def test_pack_codes_words_matches_jax(rng):
    for n in (0, 1, 7, 8, 9, 1000):
        codes = rng.integers(0, 5, n).astype(np.uint8)
        np.testing.assert_array_equal(wire.pack_codes_words(codes),
                                      jbs.pack_codes_words(codes))


def test_gather_packed_run_matches_jax(rng):
    N, X = 4096, 200
    flat = rng.integers(0, 5, N).astype(np.uint8)
    words = jbs.pack_codes_words(flat)
    cases = [(64 + r, 1) for r in range(8)] + \
        [(256 + r, -1) for r in range(8)] + \
        [(N - X, 1), (N - 1, -1), (3, -1), (0, 1),
         (2**32 - 95, 1)]                     # wrapped start, true -95
    i0 = np.array([c[0] for c in cases], np.uint32)
    st = np.array([c[1] for c in cases], np.int32)
    want = np.asarray(jbs.gather_packed_run(words, i0, st, X))
    got = wire.gather_packed_run(_t(words, torch.int32), _t(i0), _t(st),
                                 X).numpy()
    for b, (s0, sgn) in enumerate(cases):
        idx = (s0 if s0 < 2**31 else s0 - 2**32) + sgn * np.arange(X)
        ok = (idx >= 0) & (idx < N)            # valid lanes only
        np.testing.assert_array_equal(got[b][ok], want[b][ok])
        np.testing.assert_array_equal(got[b][ok], flat[idx[ok]])


def _window_cases(rng, M, W, reads, offs, Lref):
    """Descriptor columns for gap / left / right windows of both
    strands, with some target windows at the reference start so the
    band head runs off it (tests/test_gather_dispatch.py recipe)."""
    cols = {k: [] for k in ("qb", "qs", "qc", "tb", "ts", "m", "n", "lo")}

    def add(qd, td, m, n, lo):
        for k, v in zip(("qb", "qs", "qc"), qd):
            cols[k].append(v)
        cols["tb"].append(td[0])
        cols["ts"].append(td[1])
        cols["m"].append(m)
        cols["n"].append(n)
        cols["lo"].append(lo)

    for ri, read in enumerate(reads):
        L, off = len(read), int(offs[ri])
        for strand in (0, 1):
            w0 = int(rng.integers(0, L - 20))
            m = int(rng.integers(1, min(M, L - w0)))
            ra = int(rng.integers(0, 40)) if ri % 2 else \
                int(rng.integers(0, Lref - 200))
            n = int(rng.integers(max(1, m - 30), m + 30))
            add(JaxAligner._qdesc(off, L, strand, w0, m, 0), (ra, 1), m, n,
                int(jbs.global_lo(m, n, W)))
            r0 = int(rng.integers(1, 60)) if ri % 2 else \
                int(rng.integers(50, Lref))
            add(JaxAligner._qdesc(off, L, strand, w0, m, 1), (r0 - 1, -1),
                m, min(m + 48, r0), -(W // 2))
            re_ = int(rng.integers(0, 30)) if ri % 2 else \
                int(rng.integers(0, Lref - 10))
            add(JaxAligner._qdesc(off, L, strand, w0, m, 0), (re_, 1), m,
                min(m + 48, Lref - re_), -(W // 2))
    return {k: np.asarray(v, np.int64) for k, v in cols.items()}


@pytest.mark.parametrize("M,W", [(128, 128), (256, 256)])
def test_gather_windows_matches_jax(rng, M, W):
    Lref = 5000
    ref = rng.integers(0, 4, Lref).astype(np.uint8)
    ref[100:110] = 4                       # N run
    reads = [rng.integers(0, 5, int(rng.integers(60, 300))).astype(np.uint8)
             for _ in range(6)]
    flat = np.concatenate(reads)
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    c = _window_cases(rng, M, W, reads, offs, Lref)
    fw, rw = jbs.pack_codes_words(flat), jbs.pack_codes_words(ref)
    want_q, want_t = jbs.gather_windows(
        fw, rw, c["qb"].astype(np.int32), c["qs"].astype(np.int32),
        c["qc"].astype(np.int32), c["tb"].astype(np.uint32),
        c["ts"].astype(np.int32), c["m"].astype(np.int32),
        c["n"].astype(np.int32), c["lo"].astype(np.int32), M=M, W=W)
    got_q, got_t = wire.gather_windows(
        _t(fw, torch.int32), _t(rw, torch.int32), _t(c["qb"]), _t(c["qs"]),
        _t(c["qc"]), _t(c["tb"]), _t(c["ts"]), _t(c["m"]), _t(c["n"]),
        _t(c["lo"]), M=M, W=W)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    # some band heads really ran off the reference start
    assert ((c["tb"] + c["ts"] * c["lo"]) < 0).any()


def test_desc_wire_and_global_lo_match_jax(rng):
    K = 256
    qb = rng.integers(0, 2**30, K)
    qs = np.where(rng.random(K) < 0.5, 1, -1)
    qc = rng.integers(0, 2, K)
    tb = rng.integers(0, 2**32, K, dtype=np.uint64).astype(np.int64)
    ts = np.where(rng.random(K) < 0.5, 1, -1)
    m = rng.integers(0, 2049, K)
    n = rng.integers(0, 2305, K)
    lo = rng.integers(-2304, 1, K)
    glob = rng.random(K) < 0.5
    bonus = np.where(glob, 0, rng.integers(0, 100, K))
    desc = wire.pack_desc(qb, qs, qc, tb, ts, m, n, lo, glob, bonus)
    np.testing.assert_array_equal(
        desc, jbs.pack_desc(qb, qs, qc, tb, ts, m, n, lo, glob, bonus))
    want = jbs.unpack_desc(jnp.asarray(desc))
    got = wire.unpack_desc(torch.from_numpy(desc))
    for name, g, w in zip(("q_base", "q_step", "q_comp", "t_base", "t_step",
                           "m_len", "n_len", "lo", "is_global", "bonus"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(g.numpy().dtype),
                                      err_msg=name)
    W = 256
    np.testing.assert_array_equal(wire.global_lo(m, n, W),
                                  jbs.global_lo(m, n, W))


def test_extract_scores_matches_jax(rng):
    B, W = 64, 128
    h = rng.integers(-50, 50, (B, W)).astype(np.int32)
    h[:, ::7] = -(1 << 29)                     # dead lanes
    h[5] = 3                                   # all-tie row: first lane
    m = rng.integers(0, 200, B).astype(np.int32)
    n = (m + rng.integers(-40, 40, B)).clip(0).astype(np.int32)
    lo = rng.integers(-100, 1, B).astype(np.int32)
    want = jbs.extract_scores(h, m, n, lo)
    got = wire.extract_scores(torch.from_numpy(h), _t(m), _t(n), _t(lo))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture
def jax_interpret_kernels(monkeypatch):
    """Run JAX's fused chunk with its Pallas kernels in interpret mode
    (they cannot compile for the CPU)."""
    monkeypatch.setattr(banded_sw_pallas, "banded_sw_pallas",
                        functools.partial(banded_sw_pallas.banded_sw_pallas,
                                          interpret=True))
    monkeypatch.setattr(traceback_pallas, "traceback_pallas",
                        functools.partial(traceback_pallas.traceback_pallas,
                                          interpret=True))


def test_dp_tb_gather_chunk_matches_jax(rng, jax_interpret_kernels):
    """A whole chunk — unpack, gather, row DP, clip decision, traceback,
    compact encode — equals JAX _dp_tb_fused_gather word for word,
    globals and extensions mixed, zdrop on, padding rows included."""
    M, W, Bp = 256, 128, 32
    Lref = 6000
    ref = rng.integers(0, 4, Lref).astype(np.uint8)
    reads = [rng.integers(0, 4, int(rng.integers(150, 400))).astype(np.uint8)
             for _ in range(4)]
    for r in reads:                            # similar to the reference
        s = int(rng.integers(0, Lref - 500))
        r[:] = ref[s:s + len(r)]
        mut = rng.random(len(r)) < 0.08
        r[mut] = rng.integers(0, 4, int(mut.sum()))
    flat = np.concatenate(reads)
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    c = _window_cases(rng, M, W, reads, offs, Lref)
    K = len(c["m"])
    glob = c["lo"] != -(W // 2)
    desc = np.zeros((Bp, 4), np.int32)
    desc[K:, 3] = jbs._LO_BIAS                # padding rows: m = n = 0
    desc[:K] = jbs.pack_desc(c["qb"], c["qs"], c["qc"], c["tb"], c["ts"],
                             c["m"], c["n"], c["lo"], glob,
                             np.where(glob, 0, 5))
    fw, rw = jbs.pack_codes_words(flat), jbs.pack_codes_words(ref)
    want = np.asarray(jbs._dp_tb_fused_gather(
        jnp.asarray(fw), jnp.asarray(rw), jnp.asarray(desc), M=M, W=W,
        match=S.match, mismatch=S.mismatch, gapo=S.gap_open,
        gape=S.gap_ext, zdrop=S.zdrop))
    got = dp_tb_gather(_t(fw, torch.int32), _t(rw, torch.int32),
                       torch.from_numpy(desc), M=M, W=W, scores=S,
                       zdrop=S.zdrop).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (Bp, M // 32 + wire.compact_words(M) + 3)


def test_longest_first_orders_instances_by_descending_steps():
    """The DP kernels' instance order: descending step count, ties in
    index order, int32, on the device of its input."""
    steps = torch.tensor([5, 9, 5, 0, 9, 12, 1], dtype=torch.int32)
    order = wire.longest_first(steps)
    assert order.dtype == torch.int32 and order.device == steps.device
    assert order.tolist() == [5, 1, 4, 0, 2, 6, 3]
    rng = np.random.default_rng(4)
    steps = torch.from_numpy(rng.integers(0, 50, 300).astype(np.int32))
    order = wire.longest_first(steps).long()
    s = steps[order]
    assert bool((s[:-1] >= s[1:]).all())
    tie = s[:-1] == s[1:]
    assert bool((order[:-1][tie] < order[1:][tie]).all())
