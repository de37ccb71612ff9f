"""The content API of the port's DpBatcher (add_global / add_extend,
lamsa_tpu_torch/pipeline/extend.py) against the JAX package's DpBatcher
on the CPU, exact DpResults: the cases of tests/test_gather_dispatch.py
(content equals descriptor, with zero-length instances; long gaps in
the (5120, 256) bucket against the oracle) and tests/test_edge_cases.py
(the zdrop extension pair), with no mesh, a mesh of one entry and three
CPU entries; and the ranges each chunk is split into, one per entry."""

import numpy as np
import pytest
import torch

from lamsa_tpu.config import ScoreParams as JaxScores
from lamsa_tpu.io.sam import cigar_pairs
from lamsa_tpu.ops import oracle
from lamsa_tpu.pipeline.extend import DpBatcher as JaxBatcher
from lamsa_tpu_torch.config import ScoreParams
from lamsa_tpu_torch.ops.wire import pack_codes_words
from lamsa_tpu_torch.parallel.mesh import make_mesh, row_blocks
from lamsa_tpu_torch.pipeline import extend
from lamsa_tpu_torch.pipeline.extend import DpBatcher

torch.set_num_threads(1)

SC = dict(match=1, mismatch=3, gap_open=2, gap_ext=1)
MESHES = {"one": None, "one_entry": ("cpu",), "three": ("cpu",) * 3}


def _mesh(name):
    return make_mesh(MESHES[name]) if MESHES[name] else None


def _batcher(name, scores):
    """A content-only batcher on the CPU or over the named mesh."""
    return DpBatcher(scores, device="cpu", mesh=_mesh(name))


def _same(a, b):
    assert a.score == b.score
    np.testing.assert_array_equal(a.cigar, b.cigar)
    assert (a.q_used, a.t_used) == (b.q_used, b.t_used)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_content_matches_descriptors_and_jax(mesh):
    """tests/test_gather_dispatch.py test_batcher_desc_matches_content:
    the same globals (both read strands, zero-length D and I gaps) and
    extensions through add_global / add_extend, through the descriptor
    enqueue, and through the JAX batcher's content enqueue."""
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 5, 4000).astype(np.uint8)
    refc = rng.integers(0, 5, 8000).astype(np.uint8)
    words = tuple(torch.from_numpy(pack_codes_words(a))
                  for a in (flat, refc))
    b_content = _batcher(mesh, ScoreParams(**SC))
    b_desc = DpBatcher(ScoreParams(**SC), device_sources=[words] * len(
                       MESHES[mesh]) if MESHES[mesh] else words,
                       host_sources=(flat, refc), mesh=_mesh(mesh))
    b_jax = JaxBatcher(JaxScores(**SC))

    K = 40
    qb = rng.integers(0, 3000, K)
    m = rng.integers(0, 120, K)
    m[:3] = 0                                    # trivial D gaps
    n = np.maximum(m + rng.integers(-20, 20, K), 0)
    n[3:5] = 0                                   # trivial I gaps
    tb = rng.integers(0, 7000, K)
    qs = np.where(np.arange(K) % 2 == 0, 1, -1)
    qb = np.where(qs < 0, qb + 200, qb)
    qc = (np.arange(K) % 3 == 0).astype(np.int64)

    handles = []
    for i in range(K):
        q = flat[qb[i] + qs[i] * np.arange(m[i])].astype(np.uint8)
        if qc[i]:
            q = np.where(q < 4, 3 - q, q).astype(np.uint8)
        t = refc[tb[i]:tb[i] + n[i]]
        handles.append((b_content.add_global(q, t), b_jax.add_global(q, t)))
    h_desc = np.zeros(K, np.int64)
    for sgn in (1, -1):
        sel = np.flatnonzero(qs == sgn)
        h0 = b_desc.add_globals_bulk(m[sel], n[sel], qb[sel], sgn, qc[sel],
                                     tb[sel])
        h_desc[sel] = h0 + np.arange(len(sel))
    ext = []
    for _ in range(8):
        me = int(rng.integers(0, 100))
        ne = me + int(rng.integers(0, 40))
        qb_e, tb_e = int(rng.integers(0, 3000)), int(rng.integers(0, 7000))
        q, t = flat[qb_e:qb_e + me], refc[tb_e:tb_e + ne]
        ext.append((b_content.add_extend(q, t, 5),
                    b_desc.add_extend_desc(me, ne, 5, (qb_e, 1, 0),
                                           (tb_e, 1)),
                    b_jax.add_extend(q, t, 5)))
    for b in (b_content, b_desc, b_jax):
        b.run()
    for i, (hc, hj) in enumerate(handles):
        _same(b_content.result(hc), b_jax.result(hj))
        _same(b_content.result(hc), b_desc.result(int(h_desc[i])))
    for hc, hd, hj in ext:
        _same(b_content.result(hc), b_jax.result(hj))
        _same(b_content.result(hc), b_desc.result(hd))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_chunks_split_into_one_range_per_entry(monkeypatch, mesh):
    """Every chunk is launched in contiguous ranges, one per entry that
    gets instances (row_blocks): with no mesh or a mesh of one entry,
    one range (0, K) per chunk of K instances. Ten global gap fills in
    chunks of at most 4 give chunks of 4, 4 and 2, and the results equal
    the JAX batcher's."""
    monkeypatch.setitem(extend.CHUNK_BY_M, (128, 128), 4)
    seen = []
    real = DpBatcher._collect

    def collect(self, sl, M, W, parts, topdown=False):
        seen.append((len(sl["m"]), [(a, b) for a, b, *_ in parts]))
        return real(self, sl, M, W, parts, topdown)

    monkeypatch.setattr(DpBatcher, "_collect", collect)
    rng = np.random.default_rng(3)
    b = _batcher(mesh, ScoreParams(**SC))
    bj = JaxBatcher(JaxScores(**SC))
    hs = []
    for m in rng.integers(20, 100, 10):
        t = rng.integers(0, 4, int(m) + int(rng.integers(-10, 10)))
        t = t.astype(np.uint8)
        hs.append((b.add_global(t[:m], t), bj.add_global(t[:m], t)))
    b.run()
    bj.run()
    for h, hj in hs:
        _same(b.result(h), bj.result(hj))
    n = len(MESHES[mesh] or ("cpu",))
    assert sorted(k for k, _ in seen) == [2, 4, 4]
    for k, ranges in seen:
        assert ranges == [(a, c) for a, c in row_blocks(k, n) if a < c]
        if n == 1:
            assert ranges == [(0, k)]


def test_descriptors_given_ride_the_batchers_sources():
    """With device sources, add_global / add_extend given (qd, td) read
    the batcher's sources (the JAX device path's rule) and stage
    nothing; the results equal the content enqueue's."""
    rng = np.random.default_rng(1)
    flat = rng.integers(0, 4, 2000).astype(np.uint8)
    refc = rng.integers(0, 4, 3000).astype(np.uint8)
    src = tuple(torch.from_numpy(pack_codes_words(a))
                for a in (flat, refc))
    b = DpBatcher(ScoreParams(**SC), device_sources=src,
                  host_sources=(flat, refc))
    c = DpBatcher(ScoreParams(**SC), device="cpu")
    hs = []
    for _ in range(6):
        q0, t0 = int(rng.integers(0, 1800)), int(rng.integers(0, 2800))
        m, n = int(rng.integers(20, 150)), int(rng.integers(20, 150))
        q, t = flat[q0:q0 + m], refc[t0:t0 + n]
        hs.append((b.add_global(q, t, (q0, 1, 0), (t0, 1)),
                   c.add_global(q, t)))
        hs.append((b.add_extend(q, t, 5, (q0, 1, 0), (t0, 1)),
                   c.add_extend(q, t, 5)))
    assert b._staged_len == [0, 0] and c._staged_len != [0, 0]
    b.run()
    c.run()
    for hb, hc in hs:
        _same(b.result(hb), c.result(hc))


def test_long_gaps_content_match_jax_and_oracle():
    """tests/test_gather_dispatch.py test_batcher_long_gap_bucket_matches
    _oracle: global gaps of 2100-4999 bp route to (5120, 256) and come
    back equal to the JAX batcher's and to the oracle."""
    rng = np.random.default_rng(0)
    scores = JaxScores(**SC)
    b = _batcher("one", ScoreParams(**SC))
    bj = JaxBatcher(scores)
    cases = []
    for m in (2100, 3000, 4999):
        q = rng.integers(0, 4, m).astype(np.uint8)
        drift = int(rng.integers(-80, 80))
        t = q.copy()
        subs = rng.random(m) < 0.1
        t[subs] = rng.integers(0, 4, int(subs.sum()))
        t = np.concatenate([t, rng.integers(0, 4, max(drift, 0))])[
            :m + drift].astype(np.uint8)
        cases.append((b.add_global(q, t), bj.add_global(q, t), q, t))
    b.run()
    bj.run()
    W = 256
    for h, hj, q, t in cases:
        r = b.result(h)
        _same(r, bj.result(hj))
        m, n = len(q), len(t)
        lo = min(0, n - m) - (W - (abs(n - m) + 1)) // 2
        exp_score, exp_cig = oracle.banded_global(q, t, scores, lo,
                                                  lo + W - 1)
        assert r.score == exp_score
        assert list(cigar_pairs(r.cigar)) == exp_cig
        assert (r.q_used, r.t_used) == (m, n)


@pytest.mark.parametrize("zdrop,want", [(50, (224, 224)), (0, (456, 328))])
def test_zdrop_extension_pair(zdrop, want):
    """tests/test_edge_cases.py test_zdrop_clips_extension_at_junk: a
    junk block then a spurious recovery stops at the pre-junk peak with
    zdrop on and extends through with it off, as in the JAX batcher."""
    rng = np.random.default_rng(9)
    t = rng.integers(0, 4, 456).astype(np.uint8)
    q = t.copy()
    q[224:256] = 4                      # drop 69 at group boundary 256
    b = DpBatcher(ScoreParams(zdrop=zdrop), device="cpu")
    bj = JaxBatcher(JaxScores(zdrop=zdrop))
    h, hj = b.add_extend(q, t, to_end_bonus=5), bj.add_extend(q, t, 5)
    b.run()
    bj.run()
    r = b.result(h)
    _same(r, bj.result(hj))
    assert (r.q_used, r.score) == want
