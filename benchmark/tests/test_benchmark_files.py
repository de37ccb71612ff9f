"""The manifest, the files it names, the import guard and the harness's
refusal to run without a card."""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import run, traffic
from benchmark.genome import make_genome
from conftest import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_names_only_files_under_its_paths():
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    for c in MANIFEST["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_its_files(cell):
    c = run.Cell(cell)
    assert c.config["entry"] == "align_reads" and c.entry_path.is_file()
    assert set(c.limits) >= {"part_miss", "record_faults", "dp_gap",
                             "dp_sample"}
    assert c.limits["record_faults"]["limit"] == 0
    # a metric with no list of cells reads in every cell
    assert set(c.metric_paths) == {m["name"] for m in MANIFEST["per_layer"]
                                   if cell in m.get("workloads", [cell])}
    for name, path in c.metric_paths.items():
        mod = run.load_module(path, f"m_{name}")
        assert callable(mod.read)


def test_every_listed_workload_is_a_cell():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", [])) <= set(CELLS), m["name"]


def _named_files():
    """The files under each of the cell directories that the manifest
    names, each as its path below that directory."""
    configs = [json.loads((ROOT / c["file"]).read_text())
               for c in MANIFEST["configs"]]
    return {
        "configs": {Path(c["file"]).relative_to("benchmark/configs")
                    .as_posix() for c in MANIFEST["configs"]},
        "traffic": {f"{w['traffic']}.json" for w in MANIFEST["workloads"]},
        "limits": {f"{w['name']}.json" for w in MANIFEST["workloads"]},
        "metrics": {f"{m['name']}.py" for m in MANIFEST["per_layer"]},
        "entries": {f"{c['entry']}.py" for c in configs},
    }


@pytest.mark.parametrize("sub", sorted(_named_files()))
def test_every_cell_file_is_named_by_the_manifest(sub):
    """No file of a configuration, traffic mix, cell, metric or entry
    lies there unused: a cell a later change adds brings its own."""
    have = {p.relative_to(BENCH / sub).as_posix()
            for p in (BENCH / sub).rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}
    assert have == _named_files()[sub]


@pytest.fixture(scope="module")
def entry():
    return run.load_module(BENCH / "entries" / "align_reads.py",
                           "entry_align_reads")


def test_align_config_builds_what_the_entry_built_before(entry):
    """ecoli_k13's section (scores, seed_step) gives, field by field, the
    AlignConfig that the entry built from those two keys alone."""
    al = json.loads((BENCH / "configs" / "ecoli_k13.json").read_text()
                    )["align"]
    assert set(al) == {"scores", "seed_step"}
    got = entry.align_config(al)
    want = entry.AlignConfig(scores=entry.ScoreParams(**al["scores"]),
                             seed_step=al["seed_step"])
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_align_config_takes_every_field_of_the_section(entry):
    got = entry.align_config({
        "scores": {"match": 2, "gap_open": 4}, "seed_step": 6, "kmer": 15,
        "seed_1edit_cands": 0, "adaptive_seed_gap_windows": 0,
        "read_len_buckets": [512, 1024]})
    assert got.scores == entry.ScoreParams(match=2, gap_open=4)
    assert (got.seed_step, got.kmer, got.seed_1edit_cands,
            got.adaptive_seed_gap_windows) == (6, 15, 0, 0)
    assert got.read_len_buckets == (512, 1024)
    assert got.max_cands_per_seed == entry.AlignConfig().max_cands_per_seed


def test_align_config_refuses_a_key_it_has_no_field_for(entry):
    with pytest.raises(ValueError, match="align.seed_len"):
        entry.align_config({"scores": {}, "seed_len": 50})
    with pytest.raises(TypeError, match="gap_close"):
        entry.align_config({"scores": {"gap_close": 1}})


@pytest.mark.parametrize("file", [c["file"] for c in MANIFEST["configs"]])
def test_every_configurations_align_section_reaches_the_aligner(entry,
                                                                file):
    al = json.loads((ROOT / file).read_text())["align"]
    assert isinstance(entry.align_config(al), entry.AlignConfig)


@pytest.mark.parametrize("mix", sorted(p.stem for p in
                                       (BENCH / "traffic").glob("*.json")))
def test_traffic_is_deterministic_by_seed(mix):
    t = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    t["pool_batches"] = 2
    g = make_genome({"chromosomes": 2, "chromosome_bp": 60_000,
                     "n_runs_per_chromosome": 1}, np.random.default_rng(3))
    a = traffic.make_pool(g, t, 10, np.random.default_rng(2**40 + 7))
    b = traffic.make_pool(g, t, 10, np.random.default_rng(2**40 + 7))
    c = traffic.make_pool(g, t, 10, np.random.default_rng(2**40 + 8))
    assert [(r.name, r.seq) for x in a for r in x] == \
        [(r.name, r.seq) for x in b for r in x]
    assert [r.seq for x in a for r in x] != [r.seq for x in c for r in x]
    # every batch, of either seed, plans the same lengths and SV count
    for pool in (a, c):
        for batch in pool:
            assert sum(";" in r.name for r in batch) == \
                round(t["sv_fraction"] * 10)


def test_genome_is_deterministic_by_seed():
    p = {"chromosomes": 2, "chromosome_bp": 50_000,
         "n_runs_per_chromosome": 3}
    a = make_genome(p, np.random.default_rng(5))
    b = make_genome(p, np.random.default_rng(5))
    assert np.array_equal(a.codes, b.codes)
    assert (a.codes == 4).sum() > 0 and list(a.offsets) == [0, 50_000,
                                                             100_000]


def test_every_seed_runs_the_same_data_in_an_order_of_its_own():
    a = run.streams(20260817, 2**33 + 5)
    b = run.streams(20260817, 2**33 + 6)
    for x, y in zip(a[:2], b[:2]):          # genome and pool of reads
        assert np.array_equal(x.integers(0, 4, 64), y.integers(0, 4, 64))
    again = run.streams(20260817, 2**33 + 5)
    assert list(a[2].permutation(16)) == list(again[2].permutation(16))
    assert list(b[2].permutation(16)) != list(again[2].permutation(16))


def test_mutate_keeps_truth_coordinates():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 2000, dtype=np.uint8)
    out, qmap = traffic.mutate(rng, codes, 0.0, 0.0, 0.0)
    assert np.array_equal(out, codes) and qmap[-1] == 2000
    out, qmap = traffic.mutate(rng, codes, 0.01, 0.05, 0.04)
    assert qmap[-1] == len(out) and np.all(np.diff(qmap) >= 0)
    kept = np.flatnonzero(np.diff(qmap) > 0)
    assert 0.9 < np.mean(out[qmap[kept]] == codes[kept]) < 1.0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    """Whole top-level names: lamsa_tpu_torch begins with lamsa_tpu."""
    tops = set(_imports(path))
    assert not tops & {"jax", "jaxlib", "flax", "lamsa_tpu"}
    if path.parent.name != "entries" and path.name != "faults.py":
        assert "lamsa_tpu_torch" not in tops, \
            "only entries/ and faults.py may import the port"


def test_run_refuses_without_a_card():
    """On this CPU build of torch there is no card: exit 2, no result."""
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    if "torch.cuda.is_available() is False" not in p.stderr:
        import torch
        if torch.cuda.is_available():
            pytest.skip("a card is present")
    assert p.returncode == 2
    assert p.stdout.strip() == ""


def test_the_entry_loads_nothing_forbidden():
    """The runtime half of the guard: what the entry pulls in of the
    port, in a fresh process, holds no jax, jaxlib, flax or lamsa_tpu."""
    code = ("import benchmark.run as r; "
            "r.load_module(r.BENCH / 'entries' / 'align_reads.py', 'e'); "
            "import benchmark.faults; print(r.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", str(2**33 + 2), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
