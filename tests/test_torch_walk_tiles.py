"""The tile schedule of the two CUDA walkers, on the CPU.

The kernels (csrc/traceback_adiag.cu, csrc/traceback_row.cu) run only on
a card; their new index arithmetic (tile origin, the drift guess, the
reload rules, cursors outside the band) is mirrored statement for
statement in numpy by ops/testing.py traceback_adiag_tiled and
traceback_row_tiled, with the tile constants the build hands the
sources (_build.WALK_TILES). Here the mirrors must equal the plain
versions exactly, must read no byte outside the tile they staged (the
mirror raises TileReadError), and must take every reload path on the
inputs built to force it."""

import numpy as np
import pytest
import torch

from lamsa_tpu_torch import _build
from lamsa_tpu_torch.config import ScoreParams
from lamsa_tpu_torch.ops import testing as T
from lamsa_tpu_torch.ops.banded_sw_adiag import banded_sw_adiag_plain
from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row_plain
from lamsa_tpu_torch.ops.traceback_adiag import traceback_adiag_plain
from lamsa_tpu_torch.ops.traceback_row import traceback_row_plain
from lamsa_tpu_torch.ops.wire import a_pad

torch.set_num_threads(1)

S = ScoreParams(match=1, mismatch=3, gap_open=2, gap_ext=1)
KW = dict(match=S.match, mismatch=S.mismatch, gapo=S.gap_open,
          gape=S.gap_ext)
SHAPES = [(128, 128), (512, 256), (5120, 256)]
BATCHES = ["globals_stress", "deletion", "edge", "indel"]
ROW_LEFT = _build.WALK_TILES["ROW_TILE_LEFT"]


def _t(arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _batch(kind, M, W, seed):
    rng = np.random.default_rng(seed)
    B = 6 if M <= 512 else 3
    if kind == "globals_stress":
        return T.make_globals(rng, B, M, W, stress=True)
    if kind == "deletion":
        return T.make_deletion_batch(rng, B, M, W)
    if kind == "edge":
        return T.edge_batch(rng, B, M, W, adiag=True)
    # a deletion past the row walker's lane window, an insertion run
    # past 32 rows
    return T.make_indel_batch(rng, B, M, W, dels=W // 2 + 8, ins=40)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_tile_constants_reach_the_compiler():
    """The sources refuse to build without the constants, and the build
    passes exactly the dictionary the mirrors read."""
    for k, v in _build.WALK_TILES.items():
        assert f"-D{k}={v}" in _build.NVCC_FLAGS
    for name in ("traceback_adiag", "traceback_row"):
        with open(f"{_build.CSRC}/{name}.cu") as fh:
            src = fh.read()
        prefix = "ADIAG" if name.endswith("adiag") else "ROW"
        for k in ("ROWS", "LANES", "LEFT"):
            assert f"{prefix}_TILE_{k}" in src
        assert "#error" in src


@pytest.mark.parametrize("kind", BATCHES)
@pytest.mark.parametrize("M,W", SHAPES)
def test_adiag_walker_tiles_match_plain(M, W, kind):
    q, t_win, m, n, lo = _t(_batch(kind, M, W, 11 * M + W))
    dirs = banded_sw_adiag_plain(q, t_win, m, n, lo, **KW)["dirs32a"]
    walk = (dirs, m, (n - m - lo).contiguous(), (lo >> 1).contiguous())
    got, counts = T.traceback_adiag_tiled(*walk, M=M)
    _same(got, traceback_adiag_plain(*walk, M=M))
    # every instance staged its tiles; the long gaps force a reload
    steps = (m + n).to(torch.int64)
    assert (counts[:, 0] >= 1).all()
    assert (counts[:, 0] <= steps // 32 + 2 + counts[:, 1]).all()
    if kind in ("deletion", "indel"):
        assert (counts[:, 1] > 0).any()
    if kind == "globals_stress":
        assert int(got[3][-1]) == 0xFFFF        # event overflow is there


@pytest.mark.parametrize("kind", BATCHES)
@pytest.mark.parametrize("M,W", SHAPES)
def test_row_walker_tiles_match_plain(M, W, kind):
    q, t_win, m, n, lo = _t(_batch(kind, M, W, 13 * M + W))
    dirs = banded_sw_row_plain(q, t_win, m, n, lo, torch.zeros_like(m),
                               **KW)["dirs32"]
    walk = (dirs, lo, m.clone(), (n - m - lo).contiguous())
    got, counts = T.traceback_row_tiled(*walk)
    want = traceback_row_plain(*walk)
    _same(got, want)
    assert (counts[:, 0] >= 1).all()
    if kind in ("deletion", "indel"):
        # a D run longer than the window's room left of the cursor
        # leaves it: the scan's reload path is taken
        runs = (want[0] & 0xFFFF)[want[0] >> 16 != 2]
        assert int(runs.max()) > ROW_LEFT + 3
        assert (counts[:, 1] > 0).any()
    if kind == "indel":
        ops = (want[0] >> 16).numpy()
        assert max(_longest_run(o == 1) for o in ops) > 32


def _longest_run(mask):
    best = cur = 0
    for v in mask:
        cur = cur + 1 if v else 0
        best = max(best, cur)
    return best


@pytest.mark.parametrize("M,W", SHAPES)
def test_row_walker_tiles_extension_and_row0_starts(M, W):
    """Extension-best starts on z-dropped N-block extensions, one walk
    from row 0, and starts whose lane is outside the band."""
    rng = np.random.default_rng(17 * M + W)
    B = 6 if M <= 512 else 3
    q, t_win, m, n, lo, zd = _t(T.make_zdrop_batch(rng, B, M, W))
    res = banded_sw_row_plain(q, t_win, m, n, lo, zd, **KW)
    si = res["best"][:, 1].contiguous()
    sd = res["best"][:, 2].contiguous()
    si[1] = 0                                    # a walk from row 0
    sd[2] = -5                                   # starts left of the band
    sd[0] = W + 3                                # and right of it
    walk = (res["dirs32"], lo, si, sd)
    got, counts = T.traceback_row_tiled(*walk)
    _same(got, traceback_row_plain(*walk))
    assert counts[1].tolist() == [0, 0]          # row 0: nothing staged


@pytest.mark.parametrize("M,W", SHAPES)
def test_walkers_tiles_match_plain_on_random_words(M, W):
    """Direction words no DP wrote: long D and I runs, cursors that
    leave the band on both sides, early stops on the antidiagonal
    layout, starts anywhere (outside the band and past the padded steps
    included). Both mirrors still equal the plain versions and read no
    byte outside a staged tile."""
    rng = np.random.default_rng(19 * M + W)
    B = 8
    V, A4 = W // 2, a_pad(M, W) // 4
    (dirs,) = _t([T.random_dirs(rng, B, M // 4, W)])
    lo, si, sd = _t([rng.integers(-W, 0, B).astype(np.int32),
                     rng.integers(1, M + 1, B).astype(np.int32),
                     rng.integers(-8, W + 8, B).astype(np.int32)])
    si[0], si[1] = M, 0
    got, counts = T.traceback_row_tiled(dirs, lo, si, sd)
    _same(got, traceback_row_plain(dirs, lo, si, sd))
    assert (counts[:, 1] > 0).any()

    (dirs_a,) = _t([T.random_dirs(rng, B, A4, V)])
    m, hl, sd_a = _t([rng.integers(1, M + 1, B).astype(np.int32),
                      rng.integers(-V // 2, 1, B).astype(np.int32),
                      rng.integers(-8, W + 8, B).astype(np.int32)])
    m[0], m[1] = M, 0
    hl[2], sd_a[2] = M, W                        # starts past the padding
    got, counts = T.traceback_adiag_tiled(dirs_a, m, sd_a, hl, M=M)
    _same(got, traceback_adiag_plain(dirs_a, m, sd_a, hl, M=M))
    assert counts[2].tolist() == [0, 0]
    assert (counts[:, 1] > 0).any()


@pytest.mark.parametrize("M,W,B", [(128, 128, 1), (128, 128, 5),
                                   (512, 128, 5)])
def test_walker_edge_walks_on_the_cpu(M, W, B):
    """The walks the card's checks use (ops/testing.py walker_edge_walks),
    here on the plain DPs: both mirrors equal the plain versions on every
    one, and each walker reloads a tile somewhere."""
    rng = np.random.default_rng(M + W + B)
    reloads = {"row": 0, "adiag": 0}
    for name, kind, walk in T.walker_edge_walks(rng, B, M, W,
                                                torch.device("cpu"), **KW):
        if kind == "row":
            got, counts = T.traceback_row_tiled(*walk)
            _same(got, traceback_row_plain(*walk))
        else:
            got, counts = T.traceback_adiag_tiled(*walk, M=M)
            _same(got, traceback_adiag_plain(*walk, M=M))
        reloads[kind] += int(counts[:, 1].sum())
    assert min(reloads.values()) > 0


def test_mirror_refuses_a_read_outside_its_tile():
    """The mirror's guard is live: a word outside the staged tile's rows
    or lanes, a word the array does not hold, and an origin that is not
    a multiple of 4 lanes all raise."""
    buf = T._TileBuf(np.zeros((8, 16), np.uint32), 2, 8)
    buf.stage(1, 4)
    assert buf.byte(3, 11, 2) == 0
    for wr, lane in ((1, 5), (4, 5), (2, 3), (2, 12)):
        with pytest.raises(T.TileReadError):
            buf.byte(wr, lane, 0)
    buf.stage(3, 12)                             # half beside the array
    assert buf.byte(6, 15, 0) == 0
    with pytest.raises(T.TileReadError):
        buf.byte(6, 16, 0)
    with pytest.raises(T.TileReadError):
        buf.stage(0, 6)
