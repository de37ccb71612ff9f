"""Tests of the benchmark, on the CPU at a tiny size. The port runs with
device="cpu" (the kernels' plain versions); tests marked `cuda` need
the card and skip without one."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skipped without one)")


TINY_CONFIG = {
    "data_seed": 20260817,
    "genome": {"chromosomes": 2, "chromosome_bp": 150_000,
               "n_runs_per_chromosome": 2, "n_run_bp": [100, 2000]},
    "index": {"kind": "kmer", "k": 13, "max_hits_per_kmer": 64},
    "align": {"scores": {"match": 1, "mismatch": 3, "gap_open": 2,
                         "gap_ext": 1, "end_bonus": 5, "zdrop": 100},
              "seed_step": 10},
    "batch_reads": 12,
    "entry": "align_reads",
}
TINY_TRAFFIC = {"read_len": [800, 2000], "sub": 0.01, "ins": 0.05,
                "del": 0.04, "sv_fraction": 0.25, "max_n_share": 0.01,
                "pool_batches": 2}
TINY_LIMITS = {"part_miss": {"limit": 0.05}, "record_faults": {"limit": 0},
               "dp_gap": {"limit": 20}, "dp_sample": 8}
NEW_METRIC = '''"""Reads the traced batches completed (a reader added as a
new file)."""


def read(ctx):
    return float(ctx["reads"]) or None
'''


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    """A copy of the benchmark's files with one cell added as new files
    only: a configuration, a traffic mix, its limits, a per-layer
    metric, and their entries in a copy of the manifest."""
    d = tmp_path_factory.mktemp("bench")
    for sub in ("configs", "traffic", "limits", "metrics", "entries"):
        shutil.copytree(BENCH / sub, d / sub)
    (d / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (d / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (d / "limits" / "tiny.tiny.json").write_text(json.dumps(TINY_LIMITS))
    (d / "metrics" / "tiny.reads_seen.py").write_text(NEW_METRIC)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "a test",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "tiny.tiny", "config": "tiny",
                             "traffic": "tiny", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "tiny.reads_seen", "unit": "reads",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry", "moves": "host_peak_rss_gib",
                             "workloads": ["tiny.tiny"]})
    (d / "BENCHMARK.json").write_text(json.dumps(man))
    return d


@pytest.fixture(scope="session")
def tiny_cell(tiny_bench):
    from benchmark import run
    return run.Cell("tiny.tiny", tiny_bench, tiny_bench / "BENCHMARK.json")
