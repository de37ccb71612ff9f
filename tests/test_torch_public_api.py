"""The last two public names of the JAX package that the port lacked:
``DpBatcher.add_global_desc`` (lamsa_tpu/pipeline/extend.py) and the
package's top-level ``AlignConfig`` / ``ScoreParams`` / ``preset``
(lamsa_tpu/__init__.py), against the JAX package on the CPU."""

import dataclasses

import numpy as np
import torch

import lamsa_tpu
from lamsa_tpu.config import ScoreParams as JaxScores
from lamsa_tpu.pipeline.extend import DpBatcher as JaxBatcher
import lamsa_tpu_torch
from lamsa_tpu_torch import config as port_config
from lamsa_tpu_torch.config import ScoreParams
from lamsa_tpu_torch.ops.wire import pack_codes_words
from lamsa_tpu_torch.pipeline import extend
from lamsa_tpu_torch.pipeline.extend import DpBatcher

torch.set_num_threads(1)

SC = dict(match=1, mismatch=3, gap_open=2, gap_ext=1)
# device sources the test never reads: the batcher takes its one entry's
# device from them
_UNREAD = (torch.zeros(1, dtype=torch.int32),) * 2


def _same(a, b):
    assert a.score == b.score
    np.testing.assert_array_equal(a.cigar, b.cigar)
    assert (a.q_used, a.t_used) == (b.q_used, b.t_used)


def test_scalar_global_desc_routes_to_the_adiag_pair(rng, monkeypatch):
    """tests/test_adiag_routing.py test_columnar_split_routes_every
    _instance on the port's batcher: bulk globals in both band widths,
    scalar extends and one scalar global (add_global_desc) in one
    batcher. Every instance is dispatched once, every handle has its
    result, and the scalar global rides an all-global antidiagonal
    chunk."""
    calls = []

    def fake_dispatch_cols(self, sl, M, W, adiag=False):
        calls.append((M, W, adiag, np.array(sl["glob"], copy=True),
                      np.array(sl["idx"], copy=True)))
        return sl, M, W, [], adiag

    def fake_collect(self, sl, M, W, parts, topdown=False):
        for i in sl["idx"]:
            self._results[int(i)] = extend.DpResult(
                0, extend._EMPTY_CIGAR, 0, 0)

    monkeypatch.setattr(DpBatcher, "_dispatch_cols", fake_dispatch_cols)
    monkeypatch.setattr(DpBatcher, "_collect", fake_collect)
    b = DpBatcher(ScoreParams(), device_sources=_UNREAD)
    K = 40
    m = rng.integers(300, 500, K)
    n = m + rng.integers(80, 110, K)          # need > 112: W = 256
    h0 = b.add_globals_bulk(m, n, np.zeros(K, np.int64), 1, 0,
                            np.arange(K, dtype=np.int64) * 1000)
    K2 = 24
    m2 = rng.integers(300, 500, K2)
    n2 = m2 + rng.integers(-10, 10, K2)       # need <= 80: W = 128 fits
    h2 = b.add_globals_bulk(m2, n2, np.zeros(K2, np.int64), 1, 0,
                            np.arange(K2, dtype=np.int64) * 1000)
    hs = [b.add_extend_desc(400, 420, 5, (0, 1, 0), (7, 1))
          for _ in range(3)]
    hg = b.add_global_desc(350, 440, (0, 1, 0), (9, 1))
    b.run()

    for h in ([h0 + i for i in range(K)] + [h2 + i for i in range(K2)]
              + hs + [hg]):
        assert b.result(h) is not None
    seen = set()
    adiag_widths = set()
    for M, W, adiag, glob, idx in calls:
        for i in idx:
            assert int(i) not in seen, "instance dispatched twice"
            seen.add(int(i))
        gb = np.asarray(glob).astype(bool)
        if adiag:
            assert gb.all(), "an adiag chunk must be all-global"
            adiag_widths.add(W)
        elif extend._adiag_bucket(M, W):
            assert not gb.any(), "a global rode a row chunk"
    assert adiag_widths == {128, 256}
    assert len(seen) == K + K2 + 4
    assert [adiag for _, _, adiag, _, idx in calls if hg in idx] == [True]


def test_global_desc_equals_bulk_and_jax():
    """add_global_desc = add_globals_bulk of one instance = the JAX
    batcher's add_global_desc (its CPU engine materializes the
    descriptors from host sources), on both read strands, complemented
    queries, trivial gaps and long gaps, exact DpResults."""
    rng = np.random.default_rng(5)
    flat = rng.integers(0, 5, 6000).astype(np.uint8)
    refc = rng.integers(0, 5, 9000).astype(np.uint8)
    words = tuple(torch.from_numpy(pack_codes_words(a))
                  for a in (flat, refc))

    def port():
        return DpBatcher(ScoreParams(**SC), device_sources=words,
                         host_sources=(flat, refc))

    b_one, b_bulk = port(), port()
    b_jax = JaxBatcher(JaxScores(**SC), host_sources=(flat, refc))
    K = 24
    m = rng.integers(1, 300, K)
    m[0], m[1] = 0, 700                      # a trivial D gap, a long gap
    n = np.maximum(m + rng.integers(-25, 25, K), 0)
    n[2] = 0                                 # a trivial I gap
    qs = np.where(np.arange(K) % 2 == 0, 1, -1)
    qb = np.where(qs < 0, rng.integers(800, 5000, K),
                  rng.integers(0, 5000, K))
    qc = (np.arange(K) % 3 == 0).astype(np.int64)
    tb = rng.integers(0, 8000, K)
    hs = []
    for i in range(K):
        qd = (int(qb[i]), int(qs[i]), int(qc[i]))
        td = (int(tb[i]), 1)
        hs.append((b_one.add_global_desc(int(m[i]), int(n[i]), qd, td),
                   b_bulk.add_globals_bulk([m[i]], [n[i]], [qb[i]], qs[i],
                                           qc[i], [tb[i]]),
                   b_jax.add_global_desc(int(m[i]), int(n[i]), qd, td)))
    for b in (b_one, b_bulk, b_jax):
        b.run()
    for h1, hb, hj in hs:
        _same(b_one.result(h1), b_bulk.result(hb))
        _same(b_one.result(h1), b_jax.result(hj))


def test_global_desc_trivial_gaps_resolve_at_once():
    """m = 0 or n = 0: resolved when enqueued, before run(), as the JAX
    batcher resolves them (pure D run, pure I run, empty)."""
    b = DpBatcher(ScoreParams(**SC), device_sources=_UNREAD)
    j = JaxBatcher(JaxScores(**SC), host_sources=(np.zeros(0, np.uint8),
                                                  np.zeros(0, np.uint8)))
    gapo, gape = SC["gap_open"], SC["gap_ext"]
    for m, n in ((0, 7), (9, 0), (0, 0)):
        h = b.add_global_desc(m, n, (0, 1, 0), (0, 1))
        hj = j.add_global_desc(m, n, (0, 1, 0), (0, 1))
        got = b.result(h)
        _same(got, j.result(hj))
        assert (got.q_used, got.t_used) == (m, n)
        assert got.score == (-(gapo + (m + n) * gape) if m + n else 0)
    assert b._scal is None and not b._bulk


def test_top_level_names_are_the_ports_and_match_the_jax_package():
    """from lamsa_tpu_torch import AlignConfig, ScoreParams, preset gives
    the port's own classes (lamsa_tpu_torch/config.py), and every preset
    equals the JAX package's field by field."""
    from lamsa_tpu_torch import AlignConfig, ScoreParams as S, preset
    assert AlignConfig is port_config.AlignConfig
    assert S is port_config.ScoreParams
    assert preset is port_config.preset
    assert AlignConfig.__module__ == "lamsa_tpu_torch.config"
    for name in ("ont", "pacbio", "hifi", "default"):
        got, want = preset(name), lamsa_tpu.preset(name)
        assert isinstance(got, lamsa_tpu_torch.AlignConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert dataclasses.asdict(AlignConfig()) == dataclasses.asdict(
        lamsa_tpu.AlignConfig())
