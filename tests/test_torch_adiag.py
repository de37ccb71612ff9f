"""The antidiagonal pair of the PyTorch port (ops/banded_sw_adiag.py,
ops/traceback_adiag.py, dp_chain.dp_tb_adiag_gather, collect_group
topdown, DpBatcher routing) against the JAX package with its Pallas
kernels in interpret mode. Exact integer equality everywhere, except
dead DP lanes of h_last, which may differ only below -20000."""

import numpy as np
import pytest
import torch

from lamsa_tpu.ops import banded_sw as jbs
from lamsa_tpu.ops import banded_sw_adiag as jadiag
from lamsa_tpu.pipeline.aln import Aligner as JaxAligner
from lamsa_tpu_torch.config import ScoreParams
from lamsa_tpu_torch.ops import wire
from lamsa_tpu_torch.ops.banded_sw_adiag import (banded_sw_adiag,
                                                 banded_sw_adiag_plain)
from lamsa_tpu_torch.ops.dp_chain import dp_tb_adiag_gather
from lamsa_tpu_torch.ops.testing import (adiag_live, make_global_chunk,
                                         make_globals)
from lamsa_tpu_torch.ops.traceback_adiag import traceback_adiag
from lamsa_tpu_torch.pipeline import extend

torch.set_num_threads(1)

S = ScoreParams()
KW = dict(match=S.match, mismatch=S.mismatch, gapo=S.gap_open,
          gape=S.gap_ext)
FLOOR = -20000
SHAPES = [(128, 256), (512, 256), (128, 128), (512, 128)]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("M,W", SHAPES)
def test_adiag_dp_plain_matches_jax(M, W):
    rng = np.random.default_rng(M + W)
    q, t_win, m, n, lo = make_globals(rng, 8, M, W, stress=True)
    want = jadiag.banded_sw_adiag(q, t_win, m, n, lo, interpret=True, **KW)
    got = banded_sw_adiag(_t(q), _t(t_win), _t(m), _t(n), _t(lo), **KW)
    wd = np.asarray(want["dirs32a"])
    gd = got["dirs32a"].numpy()
    assert gd.shape == wd.shape == (8, wire.a_pad(M, W) // 4, W // 2)
    np.testing.assert_array_equal(
        np.maximum(got["h_last"].numpy(), FLOOR),
        np.maximum(np.asarray(want["h_last"]), FLOOR))
    ud_g = jadiag.unpack_dirs_adiag(gd, m, n, lo, M, W)
    ud_w = jadiag.unpack_dirs_adiag(wd, m, n, lo, M, W)
    for b in range(8):
        np.testing.assert_array_equal(ud_g[b, :m[b]], ud_w[b, :m[b]],
                                      err_msg=f"instance {b}")
    # every word below m + n, invalid cells (nibble 0) included
    live = adiag_live(_t(m), _t(n), wd.shape[1]).numpy()
    np.testing.assert_array_equal(np.where(live, gd, 0),
                                  np.where(live, wd, 0))


@pytest.mark.parametrize("M,W", SHAPES + [(2176, 256)])
def test_adiag_walker_plain_matches_jax(M, W):
    """opbits, events, term0 and n_ev byte for byte, on dirs that hold a
    35-base deletion and a deletion ladder (both overflow; at M = 2176
    the events are wide and only the ladder overflows)."""
    rng = np.random.default_rng(7 * M + W)
    q, t_win, m, n, lo = make_globals(rng, 8, M, W, stress=True)
    dirs = banded_sw_adiag_plain(_t(q), _t(t_win), _t(m), _t(n), _t(lo),
                                 **KW)["dirs32a"]
    sd = (n - m - lo).astype(np.int32)
    hl = (lo >> 1).astype(np.int32)
    want = jadiag.traceback_adiag(dirs.numpy(), m, sd, hl, M=M,
                                  interpret=True)
    got = traceback_adiag(dirs, _t(m), _t(sd), _t(hl), M=M)
    for name, g, w in zip(("opbits", "events", "term0", "n_ev"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    n_ev = got[3].numpy()
    assert n_ev[-1] == 0xFFFF                       # more events than slots
    assert (n_ev[-2] == 0xFFFF) == (not wire.compact_wide(M))  # run > 30
    assert (n_ev[:-2] != 0xFFFF).any() and got[1].numpy().any()


@pytest.fixture(scope="module")
def adiag_wires():
    """The whole adiag chunk (descriptors -> gather -> DP -> walker ->
    wire) on both packages, M = 256, W = 256."""
    rng = np.random.default_rng(11)
    M, W, K, Bp = 256, 256, 14, 16
    fw, rw, desc = make_global_chunk(rng, M, W, K, Bp)
    (q_base, q_step, q_comp, t_base, t_step, m, n, lo, _g, _b) = \
        jbs.unpack_desc(desc)
    q, t_win = jbs.gather_windows(fw, rw, q_base, q_step, q_comp, t_base,
                                  t_step, m, n, lo, M=M, W=W)
    want = np.asarray(jbs._dp_tb_adiag_core(q, t_win, m, n, lo, M=M,
                                            interpret=True, **KW))
    got = dp_tb_adiag_gather(_t(fw), _t(rw), _t(desc), M=M, W=W, scores=S)
    return M, got, want


def test_adiag_chunk_wire_matches_jax(adiag_wires):
    M, got, want = adiag_wires
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[1] == M // 32 + wire.compact_words(M) + 3
    n_ev = (got[:, -3].numpy() >> 16) & 0xFFFF
    assert (n_ev == 0xFFFF).sum() >= 2 and ((n_ev > 0) & (n_ev < 0xFFFF)).any()


def test_collect_group_topdown_matches_jax(adiag_wires):
    M, got, want = adiag_wires
    gc, gs, gi, gd = wire.collect_group(got, M, topdown=True)
    wc, ws, wi, wd = jbs.collect_group_pallas(want, M, topdown=True)
    for a, b in ((gs, ws), (gi, wi), (gd, wd)):
        np.testing.assert_array_equal(a, b)
    assert len(gc) == len(wc)
    decoded = 0
    for g, w in zip(gc, wc):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
            decoded += 1
    assert decoded >= len(gc) - 2


@pytest.mark.parametrize("enabled", [True, False])
def test_routing_globals_to_adiag(rng, monkeypatch, enabled):
    """Both band widths reach the adiag pair, adiag chunks are
    all-global, no global rides a row chunk of an adiag bucket, every
    instance is dispatched once, and adiag chunks are collected with
    topdown events (tests/test_adiag_routing.py, for the port)."""
    calls, collects = [], []

    def fake_dispatch_cols(self, sl, M, W, adiag=False):
        calls.append((M, W, adiag, np.array(sl["glob"], copy=True),
                      np.array(sl["idx"], copy=True)))
        return sl, M, W, None, adiag

    def fake_collect(self, sl, M, W, dev, topdown=False):
        collects.append((tuple(int(i) for i in sl["idx"]), topdown))
        for i in sl["idx"]:
            self._results[int(i)] = extend.DpResult(
                0, extend._EMPTY_CIGAR, 0, 0)

    monkeypatch.setattr(extend, "ADIAG_ENABLED", enabled)
    monkeypatch.setattr(extend.DpBatcher, "_dispatch_cols",
                        fake_dispatch_cols)
    monkeypatch.setattr(extend.DpBatcher, "_collect", fake_collect)
    b = extend.DpBatcher(S, device_sources=None, host_sources=None)
    K = 40                                      # drift forces W = 256
    m = rng.integers(300, 500, K)
    n = m + rng.integers(80, 110, K)
    h0 = b.add_globals_bulk(m, n, np.zeros(K, np.int64), 1, 0,
                            np.arange(K, dtype=np.int64) * 1000)
    K2 = 24                                     # small drift: W = 128
    m2 = rng.integers(300, 500, K2)
    n2 = m2 + rng.integers(-10, 10, K2)
    h2 = b.add_globals_bulk(m2, n2, np.zeros(K2, np.int64), 1, 0,
                            np.arange(K2, dtype=np.int64) * 1000)
    # scalar extends (m > 256: a W = 256 bucket); merging them promotes
    # the glob column to int64
    hs = [b.add_extend_desc(400, 420, 5, (0, 1, 0), (7, 1))
          for _ in range(3)] + [b.add_extend_desc(100, 140, 5, (0, 1, 0),
                                                  (9, 1))]
    b.run()

    for h in [h0 + i for i in range(K)] + [h2 + i for i in range(K2)] + hs:
        assert b.result(h) is not None
    seen = set()
    widths = set()
    for M, W, adiag, glob, idx in calls:
        for i in idx:
            assert int(i) not in seen, "instance dispatched twice"
            seen.add(int(i))
        gb = np.asarray(glob).astype(bool)
        if adiag:
            assert gb.all(), "adiag chunk must be all-global"
            widths.add(W)
        elif extend._adiag_bucket(M, W):
            assert not gb.any(), "a global rode a row chunk"
    assert len(seen) == K + K2 + 4
    assert widths == ({128, 256} if enabled else set())
    assert sorted(collects) == sorted(
        (tuple(int(i) for i in idx), adiag) for _, _, adiag, _, idx in calls)


@pytest.mark.parametrize("M,W", [(128, 256), (5120, 256)])
def test_chunk_inflight_bytes(M, W):
    """Row chunks hold B*M*W direction bytes, adiag chunks B*A*V."""
    B = extend.CHUNK_BY_M[(M, W)]
    A = wire.a_pad(M, W)
    assert A == jadiag.a_pad(M, W)
    assert extend._chunk_inflight_bytes(M, W) == B * M * W + (32 << 20)
    assert extend._chunk_inflight_bytes(M, W, adiag=True) \
        == B * A * (W // 2) + (32 << 20)
    if (M, W) == (128, 256):
        assert A * (W // 2) == 2 * M * W


def test_engines_give_identical_sam(monkeypatch):
    """A small world through the port's Aligner on the CPU with
    ADIAG_ENABLED True and False: globals ride the adiag plain versions
    in the first run only, and SAM is byte-identical (and equal to the
    JAX CPU engine's)."""
    from lamsa_tpu import sim
    from lamsa_tpu.io.sam import format_sam_record as jax_format
    from lamsa_tpu_torch.io.sam import format_sam_record
    from lamsa_tpu_torch.ops.testing import port_world
    from lamsa_tpu_torch.pipeline.aln import Aligner
    from lamsa_tpu_torch.utils.timers import GLOBAL as STATS
    from tests.test_e2e import CFG, make_ref

    rng = np.random.default_rng(5)
    genome, ref, idx = make_ref(rng, 60000)
    reads = sim.simulate_reads(rng, genome, 8, read_len=(300, 1500),
                               sub=0.02, ins=0.03, dele=0.03,
                               sv_fraction=0.2, name_prefix="eng")
    own = port_world(ref, idx, CFG)
    sams, adiag = [], []
    for enabled in (True, False):
        monkeypatch.setattr(extend, "ADIAG_ENABLED", enabled)
        STATS.reset()
        out = Aligner(*own, device="cpu").align_batch(reads)
        sams.append([format_sam_record(r) for rs in out for r in rs])
        adiag.append(STATS.counters.get("dp_adiag_instances", 0))
    assert adiag[0] > 0 and adiag[1] == 0
    assert sams[0] == sams[1]
    want = [jax_format(r) for rs in
            JaxAligner(ref, idx, CFG).align_batch(reads) for r in rs]
    assert sams[0] == want


def test_adiag_wrappers_check_inputs():
    q, t_win, m, n, lo = (_t(a) for a in make_globals(
        np.random.default_rng(1), 4, 128, 128))
    with pytest.raises(ValueError, match="even"):
        banded_sw_adiag(q, t_win, m, n, lo + 1, **KW)
    with pytest.raises(ValueError):
        banded_sw_adiag(q.long(), t_win, m, n, lo, **KW)
    meta = dict(dtype=torch.int32, device="meta")
    v = torch.empty(4, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        banded_sw_adiag(torch.empty((4, 128), **meta),
                        torch.empty((4, 256), **meta), v, v, v, **KW)
    with pytest.raises(ValueError, match="no kernel"):
        traceback_adiag(torch.empty((4, 128, 64), **meta), v, v, v, M=128)
    with pytest.raises(ValueError):
        traceback_adiag(torch.zeros((4, 128, 64), dtype=torch.int32),
                        m, m, m, M=100)


@pytest.mark.parametrize("M,W", [(128, 128), (512, 256)])
def test_deletion_batch_runs_e_across_thread_edges(M, W):
    """The thread-edge cases of the DP kernels' tests: in every instance
    of make_deletion_batch some row sets the E-extension bit on at least
    W/2 - 17 consecutive lanes, more than the 8 lanes any kernel thread
    owns, so the E chain (and its tie bit, carried across a thread edge
    by a shuffle) crosses thread edges; the antidiagonal DP agrees with
    the row DP on the global score."""
    from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row_plain
    from lamsa_tpu_torch.ops.testing import make_deletion_batch, unpack_rows
    args = [_t(a) for a in make_deletion_batch(np.random.default_rng(M),
                                               4, M, W)]
    zero = torch.zeros_like(args[2])
    row = banded_sw_row_plain(*args, zero, **KW)
    e_ext = (unpack_rows(row["dirs32"]) >> 2) & 1
    for b in range(4):
        e = e_ext[b, :int(args[2][b])].to(torch.int32)
        run = torch.zeros_like(e[:, 0])
        best = 0
        for d in range(W):
            run = (run + 1) * e[:, d]
            best = max(best, int(run.max()))
        assert best >= W // 2 - 17, (b, best)
    ad = banded_sw_adiag(*args, **KW)
    g_a = wire.extract_scores(ad["h_last"], *args[2:])[0]
    g_r = wire.extract_scores(row["h_last"], *args[2:])[0]
    assert torch.equal(g_a, g_r)
