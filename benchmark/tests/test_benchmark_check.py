"""The check that decides `correct`: the plain reference against small
hand-made cases, and whole runs of a tiny cell on the CPU: sound, the
control, and each fault of faults.py, which has to come out not
correct."""

import itertools

import numpy as np
import pytest

from benchmark import faults, reference, run
from benchmark.readings import control_config

SC = {"match": 1, "mismatch": 3, "gap_open": 2, "gap_ext": 1}


def gotoh_full(q, t, sc):
    """Unbanded global affine alignment score, cell by cell."""
    go, ge = sc["gap_open"], sc["gap_ext"]
    m, n = len(q), len(t)
    NEG = -10**9
    H = [[NEG] * (n + 1) for _ in range(m + 1)]
    E = [[NEG] * (n + 1) for _ in range(m + 1)]
    F = [[NEG] * (n + 1) for _ in range(m + 1)]
    H[0][0] = 0
    for j in range(1, n + 1):
        H[0][j] = E[0][j] = -(go + ge * j)
    for i in range(1, m + 1):
        H[i][0] = F[i][0] = -(go + ge * i)
        for j in range(1, n + 1):
            E[i][j] = max(H[i][j - 1] - go - ge, E[i][j - 1] - ge)
            F[i][j] = max(H[i - 1][j] - go - ge, F[i - 1][j] - ge)
            s = sc["match"] if q[i - 1] == t[j - 1] and q[i - 1] < 4 \
                else -sc["mismatch"]
            H[i][j] = max(H[i - 1][j - 1] + s, E[i][j], F[i][j])
    return H[m][n]


def test_banded_global_equals_the_full_dp_with_a_wide_band():
    rng = np.random.default_rng(11)
    jobs, want = [], []
    for m, n in itertools.product((1, 7, 30), (5, 30, 41)):
        q = rng.integers(0, 5, m).astype(np.uint8)
        t = rng.integers(0, 4, n).astype(np.uint8)
        jobs.append((q, t, -m - 2, n + 2))
        want.append(gotoh_full(q, t, SC))
    assert reference.banded_global(jobs, SC) == want


def test_banded_global_finds_a_record_at_least_as_good():
    rng = np.random.default_rng(12)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    q = np.concatenate([t[:100], t[103:200], rng.integers(0, 4, 4)
                        .astype(np.uint8), t[200:]])
    cig = [("M", 100), ("D", 3), ("M", 97), ("I", 4), ("M", 100)]
    score, nm, dmin, dmax = reference.rescore(q, t, cig, SC)
    assert (score, nm, dmin, dmax) == (297 - 5 - 6, 7, -1, 3)
    best, = reference.banded_global([(q, t, dmin - 8, dmax + 8)], SC)
    assert best >= score


def test_as_may_keep_a_trimmed_boundary_insertion():
    assert reference.as_explained(100, 100, 0, 0, SC)
    assert reference.as_explained(97, 100, 5, 0, SC)      # 1I into clip
    assert not reference.as_explained(97, 100, 0, 0, SC)  # no clip
    assert not reference.as_explained(101, 100, 5, 5, SC)
    assert reference.as_explained(94, 100, 1, 1, SC)      # one each side
    assert not reference.as_explained(None, 100, 0, 0, SC)


def test_rescore_refuses_a_cigar_that_overruns():
    q = np.zeros(10, np.uint8)
    assert reference.rescore(q, q, [("M", 11)], SC) is None
    assert reference.rescore(q, q, [("M", 9)], SC) is None


@pytest.fixture(scope="module")
def sound(tiny_cell):
    return run.run_cell(tiny_cell, 2**35 + 3, 0.0, True, device="cpu",
                        log=lambda m: None)


def test_a_sound_tiny_run_is_correct(sound):
    res, lines = sound
    assert res["correct"], lines
    assert res["failed"] == 0 and res["attempted"] == 12
    assert list(res)[-1] == "check"
    assert res["check"]["record_faults"]["value"] == 0


def test_a_cell_added_as_files_is_found(sound, tiny_cell, tiny_bench):
    """tiny.tiny, its configuration, traffic, limits and the per-layer
    metric tiny.reads_seen exist only as new files and manifest entries
    (conftest.tiny_bench); the harness finds and reads them all, and the
    manifest's readers, which list no cells, read the new cell too. A
    run on the CPU has no device trace: its readers return nothing."""
    res, _lines = sound
    got = res["metrics"]
    assert got["tiny.reads_seen"]["value"] == 12.0
    for name in ("seeding.ms_per_read", "chaining.ms_per_read",
                 "chaining.loop_ms_per_read", "skeleton.ms_per_read",
                 "dp.ms_per_read", "dp.cells_per_read",
                 "finalize.ms_per_read"):
        assert got[name]["value"] > 0, name
        assert got[name]["unit"] == tiny_cell.units[name]
    traced = {m["name"] for m in run.load_json(
        tiny_bench / "BENCHMARK.json")["per_layer"]
        if m["source"] == "device_trace"}
    assert traced and not traced & set(got)


def test_the_control_is_not_correct(tiny_cell):
    """The control: the DP without its gap-open term."""
    res, lines = run.run_cell(tiny_cell, 2**35 + 4, 0.0, False,
                              device="cpu", log=lambda m: None,
                              program_config=control_config(
                                  tiny_cell.config))
    assert not res["correct"]
    assert res["check"]["record_faults"]["value"] > 0
    assert res["check"]["dp_gap"]["value"] > \
        res["check"]["dp_gap"]["limit"]


@pytest.mark.parametrize("name", sorted(faults.FAULTS))
def test_each_fault_is_not_correct(tiny_cell, name):
    res, lines = run.run_cell(tiny_cell, 2**35 + 5, 0.0, False,
                              device="cpu", log=lambda m: None,
                              fault=faults.FAULTS[name])
    assert not res["correct"], lines
