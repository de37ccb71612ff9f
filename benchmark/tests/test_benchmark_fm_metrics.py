"""The FM seeding cell's four readers on small canned snapshots: the
search and resolve stream time, the rows resolved and the 1-edit tracks
searched, each per read; 0 tracks where FM seeding ran but nothing was
re-seeded, and nothing where the snapshot holds no FM span (the k-mer
backend, or a program without them). And which readers each cell
loads: the FM cell all 19, the k-mer cell the 15 it had."""

import json

import pytest

from benchmark import run
from conftest import BENCH, ROOT

FM = ["seeding.fm_search_device_ms_per_read",
      "seeding.fm_resolve_device_ms_per_read",
      "seeding.fm_rows_per_read",
      "seeding.fm_1edit_tracks_per_read"]

# 256 reads: 0.3 s of search and 0.05 s of resolve on the stream, 40,960
# rows resolved, 1,032,192 variant tracks searched
SNAP = {"wall_s": {"seed_hits": 0.5, "fm_search": 0.01, "fm_1edit": 0.02,
                   "fm_resolve": 0.003},
        "calls": {"seed_hits": 3, "fm_search": 3, "fm_1edit": 1,
                  "fm_resolve": 3},
        "counters": {"fm_rows_resolved": 40_960,
                     "fm_1edit_tracks": 1_032_192, "reads": 256},
        "device_s": {"fm_search": 0.3, "fm_1edit": 0.2, "fm_resolve": 0.05,
                     "dp_512x128": 0.01},
        "spans": []}
CTX = {"stats": SNAP, "reads": 256}
# the k-mer backend's snapshot: seeding without any FM part
KMER = {"wall_s": {"seed_hits": 0.02}, "calls": {"seed_hits": 2},
        "counters": {"reads": 256}, "device_s": {"dp_512x128": 0.01},
        "spans": []}


def read(name, ctx=CTX):
    return run.load_module(BENCH / "metrics" / f"{name}.py", name).read(ctx)


@pytest.mark.parametrize("name,want", [
    ("seeding.fm_search_device_ms_per_read", 1e3 * 0.3 / 256),
    ("seeding.fm_resolve_device_ms_per_read", 1e3 * 0.05 / 256),
    ("seeding.fm_rows_per_read", 160.0),
    ("seeding.fm_1edit_tracks_per_read", 4032.0),
])
def test_fm_reader_arithmetic(name, want):
    assert read(name) == pytest.approx(want)


def test_tracks_read_zero_where_nothing_was_re_seeded():
    """FM search ran, the re-seed did not: no fm_1edit span, no tracks
    counter, and the reader gives 0, not nothing."""
    snap = {k: dict(v) if isinstance(v, dict) else v
            for k, v in SNAP.items()}
    del snap["wall_s"]["fm_1edit"], snap["calls"]["fm_1edit"]
    del snap["counters"]["fm_1edit_tracks"], snap["device_s"]["fm_1edit"]
    assert read("seeding.fm_1edit_tracks_per_read",
                dict(CTX, stats=snap)) == 0.0


@pytest.mark.parametrize("name", FM)
def test_fm_reader_without_fm_spans_returns_nothing(name):
    assert read(name, dict(CTX, stats=KMER)) is None
    # a snapshot as old as the program before device_s existed
    old = {k: v for k, v in KMER.items() if k != "device_s"}
    assert read(name, dict(CTX, stats=old)) is None


@pytest.mark.parametrize("name", FM)
def test_fm_reader_with_no_reads_returns_nothing(name):
    assert read(name, dict(CTX, reads=0)) is None


def test_each_cell_loads_its_readers():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    shared = [m["name"] for m in man["per_layer"] if "workloads" not in m]
    assert len(shared) == 15
    fm = run.Cell("grch38_2chr_fm.clr10k")
    assert len(fm.metric_paths) == 19
    assert set(fm.metric_paths) == set(shared) | set(FM)
    kmer = run.Cell("ecoli_k13.clr1to5k")
    assert len(kmer.metric_paths) == 15
    assert set(kmer.metric_paths) == set(shared)
    for m in man["per_layer"]:
        if m["name"] in FM:
            assert m["workloads"] == ["grch38_2chr_fm.clr10k"]
            assert (m["layer"], m["moves"]) == ("seeding", "device_peak_gib")


TINY_FM = {
    "data_seed": 20260820,
    "genome": {"chromosomes": 2, "chromosome_bp": 100_000,
               "n_runs_per_chromosome": 2, "n_run_bp": [100, 2000]},
    "index": {"kind": "fm", "sa_rate": 16},
    "align": {"scores": {"match": 1, "mismatch": 3, "gap_open": 5,
                         "gap_ext": 2, "end_bonus": 5, "zdrop": 100},
              "seed_step": 10},
    "batch_reads": 12,
    "entry": "align_reads",
}
TINY_NOISY = {"read_len": [2000, 4000], "sub": 0.08, "ins": 0.08,
              "del": 0.08, "sv_fraction": 0.25, "max_n_share": 0.01,
              "pool_batches": 1}


@pytest.fixture(scope="module")
def tiny_fm_cell(tiny_bench):
    """The FM cell's files at a tiny size beside the tiny k-mer cell:
    noisy reads, so that the re-seed runs its 1-edit tracks."""
    (tiny_bench / "configs" / "tiny_fm.json").write_text(json.dumps(TINY_FM))
    (tiny_bench / "traffic" / "tiny_noisy.json").write_text(
        json.dumps(TINY_NOISY))
    (tiny_bench / "limits" / "tiny_fm.tiny_noisy.json").write_text(
        (BENCH / "limits" / "grch38_2chr_fm.clr10k.json").read_text())
    man = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_fm", "source": "a test",
                           "file": "benchmark/configs/tiny_fm.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "tiny_fm.tiny_noisy",
                             "config": "tiny_fm", "traffic": "tiny_noisy",
                             "chips": 1, "why": "a test"})
    for m in man["per_layer"]:
        if m["name"] in FM:
            m["workloads"].append("tiny_fm.tiny_noisy")
    path = tiny_bench / "BENCHMARK_fm.json"
    path.write_text(json.dumps(man))
    return run.Cell("tiny_fm.tiny_noisy", tiny_bench, path)


def test_a_tiny_fm_cell_runs_correct_with_its_counters(tiny_fm_cell):
    """The FM path through the harness on the CPU, traced: the check
    holds (AS re-scored on every record, a 1-edit anchor's substituted
    base included), and the counter readers read; a run on the CPU adds
    no device seconds, so the two stream-time readers read nothing."""
    res, lines = run.run_cell(tiny_fm_cell, 2**35 + 21, 0.0, True,
                              device="cpu", log=lambda m: None)
    assert res["correct"], lines
    got = res["metrics"]
    assert got["seeding.fm_rows_per_read"]["value"] > 0
    assert got["seeding.fm_1edit_tracks_per_read"]["value"] > 0
    assert "seeding.fm_search_device_ms_per_read" not in got
    assert "seeding.fm_resolve_device_ms_per_read" not in got
