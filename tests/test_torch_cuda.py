"""The port's CUDA kernels against their plain torch versions, and the
FM seeding ops on the card against the CPU. Every test here is marked
``cuda`` and skips without a CUDA device; on a machine with one (and
without JAX) run them with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lamsa_tpu_torch.config import ScoreParams
from lamsa_tpu_torch.ops.testing import (adiag_live, edge_batch, make_batch,
                                         make_global_chunk, make_globals,
                                         make_zdrop_batch, unpack_rows)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

S = ScoreParams(match=1, mismatch=3, gap_open=2, gap_ext=1)
KW = dict(match=S.match, mismatch=S.mismatch, gapo=S.gap_open,
          gape=S.gap_ext)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _on(dev, arrs):
    return [torch.from_numpy(a).to(dev) for a in arrs]


def _assert_dp_equal(got, want, m_len):
    M = got["dirs32"].shape[1] * 4
    live = torch.arange(M, device=m_len.device)[None, :, None] \
        < m_len[:, None, None]
    dg = torch.where(live, unpack_rows(got["dirs32"]), 0)
    dw = torch.where(live, unpack_rows(want["dirs32"]), 0)
    assert torch.equal(dg, dw)
    assert torch.equal(got["best"], want["best"])
    assert torch.equal(got["h_last"].clamp(min=-20000),
                       want["h_last"].clamp(min=-20000))


@pytest.mark.parametrize("M,W", [(128, 128), (256, 256), (512, 128),
                                 (5120, 256)])
def test_banded_sw_row_kernel_matches_plain(dev, M, W):
    """Global instances with zdrop off, and N-block extensions with
    zdrop off and on; zdrop must change the best cell somewhere, so the
    kernel's freeze path is exercised."""
    from lamsa_tpu_torch.ops import banded_sw_row as mod
    rng = np.random.default_rng(M + W)
    B = 512 if M <= 512 else 48      # zdrop fires on 2 of 512 at M = 128
    q, t_win, m_len, n_len, lo = _on(dev, make_batch(rng, B, M, W))
    cases = [(q, t_win, m_len, n_len, lo, torch.zeros_like(m_len))]
    zq, zt, zm, zn, zlo, zd = _on(dev, make_zdrop_batch(rng, B, M, W))
    cases += [(zq, zt, zm, zn, zlo, torch.zeros_like(zd)),
              (zq, zt, zm, zn, zlo, zd)]
    bests = []
    for args in cases:
        n0 = mod.LAUNCHES
        got = mod.banded_sw_row(*args, **KW)
        assert mod.LAUNCHES == n0 + 1
        want = mod.banded_sw_row_plain(*args, **KW)
        torch.cuda.synchronize()
        _assert_dp_equal(got, want, args[2])
        bests.append(got["best"])
    assert not torch.equal(bests[1], bests[2])


@pytest.mark.parametrize("M,W", [(128, 128), (1024, 256), (5120, 256),
                                 (128, 256)])
def test_traceback_row_kernel_matches_plain(dev, M, W):
    from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row
    from lamsa_tpu_torch.ops import traceback_row as mod
    rng = np.random.default_rng(7 + M)
    q, t_win, m_len, n_len, lo = _on(dev, make_batch(rng, 48, M, W))
    zero = torch.zeros_like(m_len)
    glob = banded_sw_row(q, t_win, m_len, n_len, lo, zero, **KW)
    zq, zt, zm, zn, zlo, zd = _on(dev, make_zdrop_batch(rng, 48, M, W))
    ext = banded_sw_row(zq, zt, zm, zn, zlo, zd, **KW)
    si_e = ext["best"][:, 1].contiguous()
    si_e[0] = 0                                  # a walk from row 0
    walks = [(glob["dirs32"], lo, m_len.clone(),
              (n_len - m_len - lo).contiguous()),
             (ext["dirs32"], zlo, si_e, ext["best"][:, 2].contiguous())]
    for dirs32, lo_, si, sd in walks:
        got = mod.traceback_row(dirs32, lo_, si, sd)
        want = mod.traceback_row_plain(dirs32, lo_, si, sd)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def _row_chunk(rng, M, W, K):
    """Packed read / reference words and K descriptors of global gap
    fills and extensions on both strands, for the row pair."""
    from lamsa_tpu_torch.ops.wire import global_lo, pack_codes_words, \
        pack_desc
    flat = rng.integers(0, 5, 20000).astype(np.uint8)
    refc = rng.integers(0, 4, 50000).astype(np.uint8)
    m = rng.integers(1, M, K)
    glob = rng.random(K) < 0.5
    n = np.where(glob, np.maximum(m + rng.integers(-20, 20, K), 1),
                 np.minimum(m + 48, 200))
    qs = np.where(rng.random(K) < 0.5, 1, -1)
    qb = np.where(qs > 0, rng.integers(0, 10000, K),
                  rng.integers(M, 10000, K))
    ts = np.where(glob, 1, np.where(rng.random(K) < 0.5, 1, -1))
    tb = np.where(ts > 0, rng.integers(0, 40000, K),
                  rng.integers(300, 40000, K))
    lo = np.where(glob, global_lo(m, n, W), -(W // 2))
    desc = pack_desc(qb, qs, rng.integers(0, 2, K), tb, ts, m, n, lo, glob,
                     np.where(glob, 0, 5))
    return pack_codes_words(flat), pack_codes_words(refc), desc


def test_dp_tb_gather_cuda_matches_cpu(dev):
    """A whole descriptor chunk (gather -> DP kernel -> clip decision ->
    traceback kernel -> compact wire) on the card equals the CPU path."""
    from lamsa_tpu_torch.ops.dp_chain import dp_tb_gather
    chunk = _row_chunk(np.random.default_rng(3), 256, 128, 64)
    wires = [dp_tb_gather(*_on(d, chunk), M=256, W=128, scores=S,
                          zdrop=100).cpu()
             for d in (dev, torch.device("cpu"))]
    assert torch.equal(wires[0], wires[1])


def _batcher_results(mesh, dev):
    """One DpBatcher run over 300 global gap fills and 200 extensions on
    random codes: on one device (mesh None) or split over the mesh."""
    from lamsa_tpu_torch.pipeline.extend import DpBatcher
    from lamsa_tpu_torch.ops.wire import pack_codes_words
    rng = np.random.default_rng(11)
    flat = rng.integers(0, 4, 60000).astype(np.uint8)
    refc = rng.integers(0, 4, 90000).astype(np.uint8)
    fw, rw = (torch.from_numpy(pack_codes_words(a)) for a in (flat, refc))
    src = {d: (fw.to(d), rw.to(d)) for d in set(mesh or [dev])}
    b = DpBatcher(S, device_sources=[src[d] for d in mesh] if mesh
                  else src[dev], host_sources=(flat, refc), mesh=mesh)
    K = 300
    m = rng.integers(20, 400, K)
    n = np.maximum(m + rng.integers(-30, 30, K), 1)
    h0 = b.add_globals_bulk(m, n, rng.integers(0, 50000, K), 1, 0,
                            rng.integers(0, 80000, K))
    hs = [b.add_extend_desc(int(x), int(x) + 40, 5,
                            (int(rng.integers(600, 50000)), -1, 1),
                            (int(rng.integers(0, 80000)), 1))
          for x in rng.integers(10, 500, 200)]
    b.run()
    return b, [(r.score, r.cigar.tobytes(), r.q_used, r.t_used)
               for r in (b.result(h) for h in list(range(h0, h0 + K)) + hs)]


def test_dp_batcher_two_entries_on_one_card(dev):
    """A DpBatcher over the mesh (cuda:0, cuda:0) splits each chunk into
    two ranges, each launched on its entry's stream after the uploads;
    results equal the one-entry run instance by instance, and every
    kernel launches once per range."""
    from lamsa_tpu_torch.ops import (banded_sw_adiag, banded_sw_row,
                                     traceback_adiag, traceback_row)
    mods = (banded_sw_row, traceback_row, banded_sw_adiag, traceback_adiag)
    _, one = _batcher_results(None, dev)
    n0 = [m.LAUNCHES for m in mods]
    b, two = _batcher_results((dev, dev), dev)
    torch.cuda.synchronize()
    assert two == one
    launched = [m.LAUNCHES - n for m, n in zip(mods, n0)]
    assert min(launched) >= 2
    assert len(set(b.streams.values())) == 2
    assert torch.cuda.current_stream(dev) not in b.streams.values()


@pytest.mark.parametrize("one_entry", [False, True])
def test_dp_batcher_one_entry_runs_on_the_current_stream(dev, one_entry):
    """A DpBatcher of one entry (no mesh, or the mesh (cuda:0,)) run on
    a caller's side stream launches its chunks on that stream: it makes
    no stream of its own, and its results equal the CPU run's."""
    _, want = _batcher_results(None, torch.device("cpu"))
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        b, got = _batcher_results((dev,) if one_entry else None, dev)
    assert b.streams == {}
    assert got == want


def _content_results(d):
    """A content-only DpBatcher on device d over 120 global gap fills and
    120 extensions of random codes: (results, launches per kernel)."""
    from lamsa_tpu_torch.pipeline.extend import DpBatcher
    rng = np.random.default_rng(12)
    b = DpBatcher(S, device=d)
    hs = []
    for m in rng.integers(1, 900, 120):
        t = rng.integers(0, 5, int(m) + 30)
        q = t[:m].copy()
        mut = rng.random(len(q)) < 0.05
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        n = max(int(m) + int(rng.integers(-25, 30)), 0)
        hs += [b.add_global(q, t[:n]), b.add_extend(q, t, 5)]
    n0 = [m.LAUNCHES for m in _kernel_modules()]
    b.run()
    launched = [m.LAUNCHES - n for m, n in zip(_kernel_modules(), n0)]
    return [(r.score, r.cigar.tobytes(), r.q_used, r.t_used)
            for r in map(b.result, hs)], launched


def _kernel_modules():
    from lamsa_tpu_torch.ops import (banded_sw_adiag, banded_sw_row,
                                     traceback_adiag, traceback_row)
    return (banded_sw_row, traceback_row, banded_sw_adiag, traceback_adiag)


def test_dp_batcher_content_api_on_the_card(dev):
    """add_global / add_extend with the codes themselves: on the card
    the staged contents ride all four kernels, and every result equals
    the same batcher's on the CPU (the plain versions)."""
    out, launched = _content_results(dev)
    assert min(launched) > 0
    want, launched = _content_results("cpu")
    assert max(launched) == 0
    assert out == want


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("M,W", [(5120, 256), (128, 128)])
def test_dp_kernels_small_chunks_and_thread_edges(dev, M, W, B):
    """Fewer instances than SMs (the persistent warps run out of work at
    once), the last one with a W/2 - 16 base deletion whose E chain
    crosses every thread edge of the lane split; for the row DP also
    N-block extensions with zdrop. Both DP kernels exactly equal their
    plain versions."""
    from lamsa_tpu_torch.ops import banded_sw_adiag as ad
    from lamsa_tpu_torch.ops import banded_sw_row as row
    rng = np.random.default_rng(M + B)
    q, t_win, m_len, n_len, lo = _on(dev, edge_batch(rng, B, M, W))
    cases = [(q, t_win, m_len, n_len, lo, torch.zeros_like(m_len))]
    if B > 1:
        cases.append(tuple(_on(dev, make_zdrop_batch(rng, B, M, W))))
    for args in cases:
        got = row.banded_sw_row(*args, **KW)
        want = row.banded_sw_row_plain(*args, **KW)
        torch.cuda.synchronize()
        _assert_dp_equal(got, want, args[2])
    args = _on(dev, edge_batch(rng, B, M, W, adiag=True))
    got = ad.banded_sw_adiag(*args, **KW)
    want = ad.banded_sw_adiag_plain(*args, **KW)
    torch.cuda.synchronize()
    live = adiag_live(args[2], args[3], got["dirs32a"].shape[1])
    assert torch.equal(torch.where(live, got["dirs32a"], 0),
                       torch.where(live, want["dirs32a"], 0))
    assert torch.equal(got["h_last"].clamp(min=-20000),
                       want["h_last"].clamp(min=-20000))


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("M,W", [(5120, 256), (128, 128), (512, 128)])
def test_walkers_tile_edges_and_reloads(dev, M, W, B):
    """Both walkers on small chunks of walks that cross their tile
    edges (a deletion past the lane window, an insertion run past 32
    rows, random words whose walks leave the band): the kernel equals
    the plain version, and its own counts of tiles staged and blocking
    reloads equal the numpy mirror's of the same schedule, which takes
    the reload path."""
    from lamsa_tpu_torch.ops import testing as T
    from lamsa_tpu_torch.ops.traceback_adiag import traceback_adiag_plain
    from lamsa_tpu_torch.ops.traceback_row import traceback_row_plain
    rng = np.random.default_rng(M + W + B)
    reloads = {"row": 0, "adiag": 0}
    for name, kind, walk in T.walker_edge_walks(rng, B, M, W, dev, **KW):
        if kind == "row":
            got, counts = T.walker_counts_cuda("row", *walk)
            want = traceback_row_plain(*walk)
            _, mirror = T.traceback_row_tiled(*(x.cpu() for x in walk))
        else:
            got, counts = T.walker_counts_cuda("adiag", *walk, M=M)
            want = traceback_adiag_plain(*walk, M=M)
            _, mirror = T.traceback_adiag_tiled(*(x.cpu() for x in walk),
                                                M=M)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_), (name, kind)
        assert torch.equal(counts.cpu(), mirror), (name, kind)
        reloads[kind] += int(counts[:, 1].sum())
    assert min(reloads.values()) > 0


ADIAG_SHAPES = [(128, 128), (256, 256), (512, 128), (5120, 256)]


def _adiag_batch(dev, M, W, seed):
    rng = np.random.default_rng(seed)
    B = 256 if M <= 512 else 16
    return _on(dev, make_globals(rng, B, M, W, stress=True))


@pytest.mark.parametrize("M,W", ADIAG_SHAPES)
def test_banded_sw_adiag_kernel_matches_plain(dev, M, W):
    """Even-lo global instances with indels and N codes: every direction
    word below m + n and h_last through the -20000 floor."""
    from lamsa_tpu_torch.ops import banded_sw_adiag as mod
    q, t_win, m_len, n_len, lo = _adiag_batch(dev, M, W, 3 * M + W)
    n0 = mod.LAUNCHES
    got = mod.banded_sw_adiag(q, t_win, m_len, n_len, lo, **KW)
    assert mod.LAUNCHES == n0 + 1
    want = mod.banded_sw_adiag_plain(q, t_win, m_len, n_len, lo, **KW)
    torch.cuda.synchronize()
    live = adiag_live(m_len, n_len, got["dirs32a"].shape[1])
    assert torch.equal(torch.where(live, got["dirs32a"], 0),
                       torch.where(live, want["dirs32a"], 0))
    assert torch.equal(got["h_last"].clamp(min=-20000),
                       want["h_last"].clamp(min=-20000))


@pytest.mark.parametrize("M,W", ADIAG_SHAPES)
def test_traceback_adiag_kernel_matches_plain(dev, M, W):
    """Walks from (m, n) over the kernel's dirs32a, overflowing
    instances included."""
    from lamsa_tpu_torch.ops.banded_sw_adiag import banded_sw_adiag
    from lamsa_tpu_torch.ops import traceback_adiag as mod
    q, t_win, m_len, n_len, lo = _adiag_batch(dev, M, W, 5 * M + W)
    dirs = banded_sw_adiag(q, t_win, m_len, n_len, lo, **KW)["dirs32a"]
    sd = (n_len - m_len - lo).contiguous()
    hl = (lo >> 1).contiguous()
    n0 = mod.LAUNCHES
    got = mod.traceback_adiag(dirs, m_len, sd, hl, M=M)
    assert mod.LAUNCHES == n0 + 1
    want = mod.traceback_adiag_plain(dirs, m_len, sd, hl, M=M)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3][-1]) == 0xFFFF


def test_dp_tb_adiag_gather_cuda_matches_cpu(dev):
    """A whole all-global descriptor chunk on the antidiagonal pair (gather
    -> DP kernel -> walker kernel -> wire) on the card equals the CPU
    path."""
    from lamsa_tpu_torch.ops.dp_chain import dp_tb_adiag_gather
    fw, rw, desc = make_global_chunk(np.random.default_rng(4), 512, 128,
                                     60, 64)
    wires = [dp_tb_adiag_gather(*_on(d, (fw, rw, desc)), M=512, W=128,
                                scores=S).cpu()
             for d in (dev, torch.device("cpu"))]
    assert torch.equal(wires[0], wires[1])


MM2 = ScoreParams(match=1, mismatch=2, gap_open=2, gap_ext=1)


def _mm_wire(pair, d, scores):
    """The wire of one chunk of a DP pair on device d."""
    from lamsa_tpu_torch.ops.dp_chain import dp_tb_adiag_gather, dp_tb_gather
    if pair == "row":
        chunk = _row_chunk(np.random.default_rng(3), 256, 128, 64)
        return dp_tb_gather(*_on(d, chunk), M=256, W=128, scores=scores,
                            zdrop=100).cpu()
    chunk = make_global_chunk(np.random.default_rng(4), 512, 128, 60, 64)
    return dp_tb_adiag_gather(*_on(d, chunk), M=512, W=128,
                              scores=scores).cpu()


@pytest.mark.parametrize("pair", ["row", "adiag"])
def test_mismatch_two_chunk_matches_plain(dev, pair):
    """One chunk of each DP pair at the ONT sweep's mm2 scores (1, 2, 2,
    1), which no other check on the card uses: the wire on the card equals
    the plain versions' on the CPU, and differs from mismatch 3's, so the
    score reached the kernels."""
    got = _mm_wire(pair, dev, MM2)
    assert torch.equal(got, _mm_wire(pair, torch.device("cpu"), MM2))
    assert not torch.equal(got, _mm_wire(pair, dev, S))


def test_repeat_world_on_the_card_equals_the_cpu_path(dev):
    """tests/test_mapq.py's repeat-family world (1.5 Mb, 100 reads of 1-6
    kb, preset("pacbio"), k = 13): SAM on the card equals the CPU path's
    on every read, every kernel launches, and MAPQ >= 30 errs on < 1% of
    at least 50 records."""
    from lamsa_tpu_torch.pipeline.aln import Aligner
    from lamsa_tpu_torch.tools import repeat_bench as rb
    _g, ref, idx, cfg, reads = rb.repeat_world(1.5, 100,
                                               read_len=(1000, 6000))
    mods = _kernel_modules()
    n0 = [m.LAUNCHES for m in mods]
    got = rb.align(Aligner(ref, idx, cfg, device=dev), reads)
    torch.cuda.synchronize()
    assert min(m.LAUNCHES - n for m, n in zip(mods, n0)) > 0
    want = rb.align(Aligner(ref, idx, cfg, device="cpu"), reads)
    assert _sam_lines(got) == _sam_lines(want)
    hi = [ok for m, ok in rb.mapq_calibration(got, reads) if m >= 30]
    assert len(hi) >= 50
    assert sum(1 for ok in hi if not ok) < 0.01 * len(hi)


def test_wrappers_check_inputs_on_cuda(dev):
    from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row
    from lamsa_tpu_torch.ops.traceback_row import traceback_row
    q, t_win, m_len, n_len, lo, zd = _on(
        dev, make_zdrop_batch(np.random.default_rng(1), 4, 128, 128))
    with pytest.raises(ValueError):
        banded_sw_row(q.long(), t_win, m_len, n_len, lo, zd, **KW)
    with pytest.raises(ValueError):
        banded_sw_row(q, t_win, m_len.cpu(), n_len, lo, zd, **KW)
    dirs = torch.zeros((4, 32, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        traceback_row(dirs, lo, m_len[:3].contiguous(), lo)
    from lamsa_tpu_torch.ops.banded_sw_adiag import banded_sw_adiag
    from lamsa_tpu_torch.ops.traceback_adiag import traceback_adiag
    with pytest.raises(ValueError):
        banded_sw_adiag(q, t_win, m_len, n_len.long(), lo, **KW)
    with pytest.raises(ValueError):
        traceback_adiag(dirs, lo, m_len[:3].contiguous(), lo, M=128)


@pytest.fixture(scope="module")
def fm_world():
    """A 60 kb genome with a tandem repeat, its FM index (sa_rate 16)
    and 10 reads of 300-900 bp on both strands with substitutions."""
    from lamsa_tpu_torch.index.fmindex import FmIndex
    rng = np.random.default_rng(21)
    unit = rng.integers(0, 4, 40).astype(np.uint8)
    codes = np.concatenate([rng.integers(0, 4, 30000).astype(np.uint8),
                            np.tile(unit, 40),
                            rng.integers(0, 4, 28400).astype(np.uint8)])
    L = 1024
    reads = np.full((10, L), 4, np.int64)
    lens = rng.integers(300, 900, 10)
    for b in range(10):
        s0 = 29900 if b < 2 else int(rng.integers(0, len(codes) - 1000))
        frag = codes[s0:s0 + lens[b]].astype(np.int64)
        if b % 2:
            frag = (3 - frag[::-1]) & 3
        frag[rng.integers(0, lens[b], lens[b] // 8)] ^= 1
        reads[b, :lens[b]] = frag
    return codes, FmIndex.build(codes), reads, lens


def _fm_on(dev, fmi):
    from lamsa_tpu_torch.ops.fm import fm_device_state
    return fm_device_state(fmi, dev)


def test_fm_search_and_resolve_cuda_matches_cpu(dev, fm_world):
    """backward_search (exact and 1-edit) and resolve_rows on the card
    equal the CPU."""
    from lamsa_tpu_torch.ops import fm
    codes, fmi, _reads, _lens = fm_world
    rng = np.random.default_rng(5)
    k = 13
    starts = rng.integers(0, len(codes) - k, (16, 64))
    win = codes[starts[..., None] + np.arange(k)].astype(np.int64)
    win[0, :8] = codes[29900:29900 + k]                 # the repeat
    win[1, 3, 5] = 4
    ok = (win < 4).all(axis=2)
    rows = rng.integers(0, fmi.n + 1, 4096)
    valid = rng.random(4096) < 0.9
    outs = []
    for d in (dev, torch.device("cpu")):
        st = _fm_on(d, fmi)
        w, o = torch.from_numpy(win).to(d), torch.from_numpy(ok).to(d)
        r = fm.backward_search(w, o, st, k)
        r += fm.backward_search_1edit(w, o, st, k, kinds="sdi")
        r += (fm.resolve_rows(torch.from_numpy(rows).to(d),
                              torch.from_numpy(valid).to(d), st,
                              fmi.sa_rate),)
        outs.append([x.cpu() for x in r])
    for g, w_ in zip(*outs):
        assert torch.equal(g, w_)
    assert (outs[1][1] - outs[1][0]).max() > 16


@pytest.mark.parametrize("extra", [{}, {"seg_quota": 4, "sub1_cands": 2,
                                       "sub1_k": 15}],
                         ids=["plain", "quota_sub1"])
def test_seed_hits_fm_cuda_matches_cpu(dev, fm_world, extra):
    from lamsa_tpu_torch.pipeline.seeding import make_qpos_grid, \
        seed_hits_fm
    _codes, fmi, reads, lens = fm_world
    k = 13
    grid = make_qpos_grid(reads.shape[1], k, 5).astype(np.int64)
    kw = dict(k=k, cands_per_seed=16, max_hits=256, sa_rate=fmi.sa_rate,
              **extra)
    outs = []
    for d in (dev, torch.device("cpu")):
        h = seed_hits_fm(*(torch.from_numpy(a).to(d)
                           for a in (reads, lens, grid)),
                         _fm_on(d, fmi), **kw)
        outs.append({n: v.cpu() for n, v in h.items()})
    for n in ("qpos", "rpos", "strand", "valid"):
        assert torch.equal(outs[0][n], outs[1][n]), n
    assert outs[1]["valid"].sum() > 0


@pytest.fixture(scope="module")
def config1_like():
    """config-1's read profile (1-5 kb, 1% sub / 5% ins / 4% del, 15% SV
    reads, k = 13, seed step 10) on a 400 kb genome: 48 reads."""
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.config import AlignConfig
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.io.refpack import PackedReference
    rng = np.random.default_rng(20261017)
    genome = sim.random_genome(rng, 400_000)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    ref = PackedReference(names=[genome[0].name],
                          offsets=np.array([0, len(codes)], np.int64),
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    reads = sim.simulate_reads(rng, genome, 48, read_len=(1000, 5000),
                               sub=0.01, ins=0.05, dele=0.04,
                               sv_fraction=0.15)
    return ref, KmerIndex.build(codes, 13), AlignConfig(
        scores=S, seed_step=10), reads


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("entries", [None, ["cuda:0", "cuda:0"]],
                         ids=["one", "mesh2"])
def test_batches_on_side_streams_equal_one_stream_on_the_card(
        dev, config1_like, entries, depth):
    """align_batch run by `depth` worker threads at once, each batch on
    a CUDA stream of its own, gives align_reads' records read for read,
    with one entry and over two entries of the card, and every kernel
    launches in each run."""
    import concurrent.futures as cf

    from lamsa_tpu_torch.io.sam import format_sam_record
    from lamsa_tpu_torch.ops import (banded_sw_adiag, banded_sw_row,
                                     traceback_adiag, traceback_row)
    from lamsa_tpu_torch.pipeline.aln import Aligner, align_reads
    mods = (banded_sw_row, traceback_row, banded_sw_adiag, traceback_adiag)
    ref, idx, cfg, reads = config1_like
    aligner = Aligner(ref, idx, cfg, device=dev, mesh=entries)

    def sam(out):
        return [[format_sam_record(r) for r in recs] for recs in out]

    def on_stream(batch):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            return aligner.align_batch(batch)

    want = sam(align_reads(ref, idx, reads, cfg, batch_size=12,
                           aligner=aligner))
    n0 = [m.LAUNCHES for m in mods]
    with cf.ThreadPoolExecutor(depth) as ex:
        got = sam(recs for out in ex.map(
            on_stream, [reads[i:i + 12] for i in range(0, len(reads), 12)])
            for recs in out)
    torch.cuda.synchronize()
    assert min(m.LAUNCHES - n for m, n in zip(mods, n0)) > 0
    assert len(want) == len(reads)
    assert got == want


def test_cuda_chunk_collect_waits_on_its_event(dev, monkeypatch):
    """A DpBatcher run on a side stream, each chunk's kernels queued
    behind a spin of ~25 ms on that stream: each CUDA chunk must reach
    its collect (on the collect pool, whose current stream is another)
    with an event of the stream that launched it, and the results must
    equal the CPU run's; a copy that did not wait for the kernels would
    read the wire before they wrote it. A chunk without an event is
    refused at the collect."""
    from lamsa_tpu_torch.pipeline import extend
    seen = []
    real_collect = extend.DpBatcher._collect
    real_chunk = extend.DpBatcher._chunk

    def collect(self, sl, M, W, parts, topdown=False):
        seen.extend(done for *_, done in parts)
        return real_collect(self, sl, M, W, parts, topdown)

    def chunk(self, flat_dev, *a, **k):
        if flat_dev.device.type == "cuda":
            torch.cuda._sleep(50_000_000)
        return real_chunk(self, flat_dev, *a, **k)

    monkeypatch.setattr(extend.DpBatcher, "_collect", collect)
    monkeypatch.setattr(extend.DpBatcher, "_chunk", chunk)
    _, want = _batcher_results(None, torch.device("cpu"))
    seen.clear()
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        _, got = _batcher_results(None, dev)
    assert seen and all(isinstance(d, torch.cuda.Event) for d in seen)
    assert got == want
    b = extend.DpBatcher(S)
    wire = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="without the event"):
        real_collect(b, {}, 128, 128, [(0, 1, wire, None, None)])


def _sam_lines(out):
    from lamsa_tpu_torch.io.sam import format_sam_record
    return [format_sam_record(r) for recs in out for r in recs]


def test_threads_four_on_the_card(dev, config1_like):
    """-t 4 (finalize on a pool of four threads) on the card gives the
    records of threads = 1 read for read."""
    from lamsa_tpu_torch.pipeline.aln import Aligner
    ref, idx, cfg, reads = config1_like
    one = Aligner(ref, idx, cfg, device=dev).align_batch(reads)
    four = Aligner(ref, idx, cfg.replace(threads=4),
                   device=dev).align_batch(reads)
    assert len(one) == len(reads)
    assert _sam_lines(four) == _sam_lines(one)


# ---- two cards: a kernel runs on the card its inputs lie on


@pytest.fixture
def dev1():
    """cuda:1, with card 0 the runtime's current device for the whole
    test, as in a process that used card 0 first: a kernel launched on
    the current device rather than on its inputs' card fails there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (runs on cuda:1)")
    with torch.cuda.device(0):
        yield torch.device("cuda", 1)


@pytest.mark.parametrize("pair", ["row", "adiag"])
def test_wrappers_on_card_one_match_plain(dev1, pair):
    """Each of the four wrappers on cuda:1 equals its plain version on
    the host copy of its inputs: the row pair at the (512, 128) bucket,
    the antidiagonal pair at (256, 256). The outputs lie on cuda:1, each
    launch is counted, and card 0's allocation does not move."""
    from lamsa_tpu_torch.ops import (banded_sw_adiag, banded_sw_row,
                                     traceback_adiag, traceback_row)
    rng = np.random.default_rng(31)
    torch.cuda.reset_peak_memory_stats(0)
    base0 = torch.cuda.memory_allocated(0)
    n0 = [m.LAUNCHES for m in _kernel_modules()]
    if pair == "row":
        M, W = 512, 128
        host = [torch.from_numpy(a) for a in make_batch(rng, 64, M, W)]
        q, t_win, m_len, n_len, lo = [x.to(dev1) for x in host]
        zero = torch.zeros_like(m_len)
        got = banded_sw_row.banded_sw_row(q, t_win, m_len, n_len, lo, zero,
                                          **KW)
        want = banded_sw_row.banded_sw_row_plain(
            *host, torch.zeros_like(host[2]), **KW)
        assert got["dirs32"].device == dev1
        _assert_dp_equal({k: v.cpu() for k, v in got.items()}, want,
                         host[2])
        sd = (n_len - m_len - lo).contiguous()
        walk = (got["dirs32"], lo, m_len.clone(), sd)
        tb = traceback_row.traceback_row(*walk)
        tb_want = traceback_row.traceback_row_plain(
            *(x.cpu() for x in walk))
    else:
        M, W = 256, 256
        host = [torch.from_numpy(a)
                for a in make_globals(rng, 64, M, W, stress=True)]
        q, t_win, m_len, n_len, lo = [x.to(dev1) for x in host]
        got = banded_sw_adiag.banded_sw_adiag(q, t_win, m_len, n_len, lo,
                                              **KW)
        want = banded_sw_adiag.banded_sw_adiag_plain(*host, **KW)
        assert got["dirs32a"].device == dev1
        live = adiag_live(host[2], host[3], want["dirs32a"].shape[1])
        assert torch.equal(torch.where(live, got["dirs32a"].cpu(), 0),
                           torch.where(live, want["dirs32a"], 0))
        assert torch.equal(got["h_last"].cpu().clamp(min=-20000),
                           want["h_last"].clamp(min=-20000))
        walk = (got["dirs32a"], m_len, (n_len - m_len - lo).contiguous(),
                (lo >> 1).contiguous())
        tb = traceback_adiag.traceback_adiag(*walk, M=M)
        tb_want = traceback_adiag.traceback_adiag_plain(
            *(x.cpu() for x in walk), M=M)
    torch.cuda.synchronize(dev1)
    for g, w in zip(tb, tb_want):
        assert g.device == dev1
        assert torch.equal(g.cpu(), w)
    launched = [m.LAUNCHES - n for m, n in zip(_kernel_modules(), n0)]
    assert launched == ([1, 1, 0, 0] if pair == "row" else [0, 0, 1, 1])
    assert torch.cuda.max_memory_allocated(0) == base0


@pytest.mark.parametrize("where", ["card1", "two_cards"])
def test_aligner_on_other_cards_equals_card_zero(dev1, config1_like,
                                                 where):
    """Aligner(device="cuda:1") and Aligner over the mesh (cuda:0,
    cuda:1) give card 0's records read for read, with every kernel
    launched; the one-card aligner keeps its index on cuda:1."""
    from lamsa_tpu_torch.pipeline.aln import Aligner
    ref, idx, cfg, reads = config1_like
    want = _sam_lines(Aligner(ref, idx, cfg, device="cuda:0")
                      .align_batch(reads))
    if where == "card1":
        aligner = Aligner(ref, idx, cfg, device="cuda:1")
        assert all(t.device == dev1 for t in aligner._state.values())
    else:
        aligner = Aligner(ref, idx, cfg, mesh=["cuda:0", "cuda:1"])
    n0 = [m.LAUNCHES for m in _kernel_modules()]
    got = _sam_lines(aligner.align_batch(reads))
    assert min(m.LAUNCHES - n for m, n in zip(_kernel_modules(), n0)) > 0
    assert got == want


def test_dp_batcher_content_only_on_card_one(dev1):
    """A content-only DpBatcher(device="cuda:1") stages its codes on
    cuda:1, launches all four kernels there, and equals the CPU's."""
    got, launched = _content_results("cuda:1")
    assert min(launched) > 0
    want, _ = _content_results("cpu")
    assert got == want


def test_dp_batcher_over_two_cards(dev1):
    """A DpBatcher over the mesh (cuda:0, cuda:1): each chunk's ranges
    run on both cards and the results equal one card's."""
    _, one = _batcher_results(None, torch.device("cuda", 0))
    b, two = _batcher_results((torch.device("cuda", 0), dev1),
                              torch.device("cuda", 0))
    torch.cuda.synchronize()
    assert two == one
    assert {s.device for s in b.streams.values()} == {
        torch.device("cuda", 0), dev1}
