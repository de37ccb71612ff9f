"""The port's FM index build on several threads (index/fm_build.py,
native/fm_build.cpp) against the sequential SA-IS both packages share
(native suffix_array_full) and against the JAX package's FmIndex.build:
the suffix array, every array of the index, and the saved files, with
the threads forced to 1, 2, 3, 8 and 16 (more than the cores) on texts
that cross the thread floor (1 Mi entries a level) and the induce
blocks (64 Ki entries a thread)."""

import os

import numpy as np
import pytest

from lamsa_tpu import native as j_native
from lamsa_tpu.index import fmindex as j_fm
from lamsa_tpu_torch import native as p_native
from lamsa_tpu_torch.index import fm_build
from lamsa_tpu_torch.index import fmindex as p_fm
from lamsa_tpu_torch.utils.timers import GLOBAL


def _random(n, seed=1):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def _tandem(period, n):
    unit = _random(period, seed=10 + period)
    return np.tile(unit, n // period + 1)[:n]


def _segments():
    seg = _random(200_000, seed=5)
    return np.concatenate([seg] * 6 + [_random(777, seed=6)])


def _n_runs(n=2_000_000):
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(40):
        p = int(rng.integers(0, n - 5000))
        codes[p:p + int(rng.integers(1, 5000))] = 4
    codes[:3000] = 4                      # a run at each end
    codes[-1500:] = 4
    return codes


TEXTS = {
    "random_1M": lambda: _random(1_048_583),
    "random_4M": lambda: _random(4_000_037, seed=2),
    "all_A": lambda: np.zeros(1_500_001, np.uint8),
    **{f"tandem_{p}": (lambda p=p: _tandem(p, 1_200_000 + p))
       for p in range(1, 8)},
    "segment_200k_x6": _segments,
    "n_runs": _n_runs,
}

_cache = {}


def _text(name):
    if name not in _cache:
        _cache[name] = TEXTS[name]()
    return _cache[name]


def _reference_sa(name):
    """Sentinel-included SA of the substituted text by the sequential
    lamsa_sais_u8, which the JAX package's copy must give too."""
    key = ("sa", name)
    if key not in _cache:
        sub = p_fm.substitute_n(_text(name))
        sa = p_native.suffix_array_full(sub)
        assert np.array_equal(sa, j_native.suffix_array_full(sub))
        _cache[key] = sa
    return _cache[key]


@pytest.mark.parametrize("threads", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("name", list(TEXTS))
def test_suffix_array_equals_sequential(name, threads):
    codes = _text(name)
    text = fm_build.sort_text(codes, threads)
    want = np.empty(len(codes) + 1, np.uint8)
    want[:-1] = p_fm.substitute_n(codes) + 1
    want[-1] = 0
    assert np.array_equal(text, want)
    sa = fm_build.suffix_array(text, threads)
    assert np.array_equal(text, want)        # the type bits are cleared
    assert sa.dtype == np.uint32
    assert np.array_equal(sa, _reference_sa(name))


def _same_index(p, j):
    for f in ("n", "primary", "sa_rate"):
        assert type(getattr(p, f)) is type(getattr(j, f)), f
        assert getattr(p, f) == getattr(j, f), f
    for f in ("counts", "C", "bwt2", "occ", "ssa_marks", "ssa_rankcp",
              "ssa_pos"):
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f


# (text, length cut, sa_rate, threads): lengths with nr % 64 == 1 (the
# clipped mark word) and == 0 (one more rank checkpoint), a rate that is
# no power of two, and short texts on one thread
INDEX_CASES = [
    ("random_1M", 1_048_576, 4, 3),
    ("random_1M", 1_048_576 - 1, 16, 2),
    ("random_1M", None, 16, 8),
    ("n_runs", None, 16, 8),
    ("n_runs", 1_999_999, 10, 3),
    ("tandem_3", None, 4, 2),
    ("segment_200k_x6", None, 16, 3),
    ("random_1M", 5_000, 16, 1),
    ("n_runs", 64 * 97 + 17, 4, 1),
]


@pytest.mark.parametrize("name,cut,sa_rate,threads", INDEX_CASES)
def test_index_equals_jax(name, cut, sa_rate, threads):
    codes = _text(name)[:cut]
    p = p_fm.FmIndex(**fm_build.build(codes, sa_rate, _threads=threads))
    _same_index(p, j_fm.FmIndex.build(codes, sa_rate))


@pytest.mark.parametrize("threads", [1, 3])
def test_saved_files_identical(threads, tmp_path):
    codes = _text("n_runs")[:1_100_003]
    p = p_fm.FmIndex(**fm_build.build(codes, 16, _threads=threads))
    j = j_fm.FmIndex.build(codes, 16)
    p.save(str(tmp_path / "p"))
    j.save(str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names
    for f in names:
        assert (tmp_path / "p" / f).read_bytes() \
            == (tmp_path / "j" / f).read_bytes(), f


@pytest.mark.parametrize("case", ["below_floor", "affinity"])
def test_threads_spans_and_phase_lines(case, monkeypatch, capsys):
    """The thread count is the CPU affinity's from PARALLEL_MIN bases up,
    1 below it; every build adds it to fm_build_threads and records the
    spans fm_build_sa and fm_build_arrays."""
    if case == "below_floor":
        codes, want = _text("random_1M")[:fm_build.PARALLEL_MIN - 1], 1
    else:
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1, 2})
        codes, want = _text("random_4M")[:fm_build.PARALLEL_MIN], 3
    before = GLOBAL.snapshot(spans=False)
    idx = p_fm.FmIndex.build(codes, 16)
    after = GLOBAL.snapshot(spans=True)
    count = lambda snap: snap["counters"].get("fm_build_threads", 0)
    calls = lambda snap, s: snap["calls"].get(s, 0)
    assert count(after) - count(before) == want
    for span in ("fm_build_sa", "fm_build_arrays"):
        assert calls(after, span) - calls(before, span) == 1
        assert any(s["name"] == span for s in after["spans"])
    err = capsys.readouterr().err
    assert "[fmindex build] suffix array (" in err
    assert "[fmindex build] bwt, occ and sampled SA (" in err
    _same_index(idx, j_fm.FmIndex.build(codes, 16))
