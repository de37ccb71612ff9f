"""The PyTorch port imports no JAX and nothing of the JAX package (it
keeps its own copies of the JAX-free modules), and never runs on the
CPU when CUDA was asked for."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "lamsa_tpu_torch", "lamsa_tpu_torch._build", "lamsa_tpu_torch.cli",
    "lamsa_tpu_torch.config", "lamsa_tpu_torch.eval",
    "lamsa_tpu_torch.index.fmindex", "lamsa_tpu_torch.index.kmer",
    "lamsa_tpu_torch.io.fasta", "lamsa_tpu_torch.io.refpack",
    "lamsa_tpu_torch.io.sam", "lamsa_tpu_torch.io.samcheck",
    "lamsa_tpu_torch.native",
    "lamsa_tpu_torch.ops.banded_sw_adiag",
    "lamsa_tpu_torch.ops.banded_sw_row", "lamsa_tpu_torch.ops.chain",
    "lamsa_tpu_torch.ops.dp_chain", "lamsa_tpu_torch.ops.fm",
    "lamsa_tpu_torch.ops.testing",
    "lamsa_tpu_torch.ops.traceback_adiag",
    "lamsa_tpu_torch.ops.traceback_row", "lamsa_tpu_torch.ops.wire",
    "lamsa_tpu_torch.parallel.mesh", "lamsa_tpu_torch.parallel.multihost",
    "lamsa_tpu_torch.parallel.sharded_index",
    "lamsa_tpu_torch.pipeline.aln",
    "lamsa_tpu_torch.pipeline.extend", "lamsa_tpu_torch.pipeline.seeding",
    "lamsa_tpu_torch.pipeline.skeleton", "lamsa_tpu_torch.pipeline.state",
    "lamsa_tpu_torch.sim",
    "lamsa_tpu_torch.utils.timers", "lamsa_tpu_torch.utils.transfer",
    "lamsa_tpu_torch.worlds",
]
# what the port must never load: JAX ("port") and the JAX package
# itself, whose name lamsa_tpu_torch also starts with ("reused")
FORBIDDEN = {
    "port": "m == 'jax' or m.startswith('jax.')",
    "reused": "m == 'lamsa_tpu' or m.startswith('lamsa_tpu.')",
}
NO_JAX_PACKAGE = ("[m for m in sys.modules if m == 'lamsa_tpu' "
                  "or m.startswith('lamsa_tpu.')]")

# every Python file of the port, and the on-card smoke test
PORT_FILES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "lamsa_tpu_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(ROOT, "chip_smoke.py")])


def _run(code, *args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("kind", ["port", "reused"])
def test_modules_import_without_jax(kind):
    """Importing every port module, one after another in a fresh
    process, loads no JAX ("port") and no module of the JAX package
    ("reused")."""
    code = ("import importlib, sys\n"
            f"for name in {PORT_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            f"    bad = [m for m in sys.modules if {FORBIDDEN[kind]}]\n"
            "    assert not bad, (name, bad)\n"
            "print('ok')\n")
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            # "from tools import x" names the package tools
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_files_import_nothing_of_the_jax_package(path):
    """Static check: no file of the port, and not chip_smoke.py, imports
    lamsa_tpu, bench or tools, at any level of the file."""
    with open(os.path.join(ROOT, path)) as fh:
        tree = ast.parse(fh.read(), path)
    bad = sorted({n for n in _imported_names(tree)
                  if n.split(".")[0] in ("lamsa_tpu", "bench", "tools")})
    assert not bad, f"{path} imports {bad}"


def test_cli_index_and_aln_on_cpu_without_jax(tmp_path):
    """index + aln --device cpu through the port's CLI in a fresh
    process, plain and with -d 2, a shard of two and --resume: SAM comes
    out, and neither jax nor any module of the JAX package is ever
    imported."""
    from lamsa_tpu import sim
    from lamsa_tpu.io.fasta import write_fasta, write_fastq
    rng = np.random.default_rng(7)
    genome = sim.random_genome(rng, 30000)
    reads = sim.simulate_reads(rng, genome, 4, read_len=(400, 900))
    fa, fq = str(tmp_path / "g.fa"), str(tmp_path / "r.fq")
    write_fasta(fa, genome)
    write_fastq(fq, reads)
    out, shard = str(tmp_path / "o.sam"), str(tmp_path / "s.sam")
    code = ("import sys\n"
            "from lamsa_tpu_torch.cli import main\n"
            "fa, fq, out, shard = sys.argv[1:]\n"
            "aln = ['aln', '--device', 'cpu']\n"
            "rc = main(['index', '-k', '13', fa])\n"
            "rc = rc or main(aln + ['-o', out, fa, fq])\n"
            "rc = rc or main(aln + ['-d', '2', '-o', out + '2', fa, fq])\n"
            "rc = rc or main(aln + ['--batch-reads', '2', '--num-shards',"
            " '2', '--shard-id', '1', '-o', shard, fa, fq])\n"
            "rc = rc or main(aln + ['--resume', '-o', out, fa, fq])\n"
            "assert 'jax' not in sys.modules\n"
            f"assert not {NO_JAX_PACKAGE}, {NO_JAX_PACKAGE}\n"
            "sys.exit(rc)\n")
    r = _run(code, fa, fq, out, shard)
    assert r.returncode == 0, r.stderr
    recs = [ln for ln in open(out) if not ln.startswith("@")]
    assert len(recs) >= 4
    assert all(not int(ln.split("\t")[1]) & 4 for ln in recs)
    no_pg = [[ln for ln in open(p) if not ln.startswith("@PG")]
             for p in (out, out + "2")]
    assert no_pg[0] == no_pg[1]
    assert "resuming after 4 reads" in r.stderr
    assert any(ln.startswith("@CO\tlamsa_tpu_shard:1/2") for ln in
               open(shard))


def test_cuda_requests_never_run_on_cpu():
    """Without CUDA, asking for it raises; the kernel wrappers launch or
    raise for any tensor that is not on the CPU."""
    from lamsa_tpu_torch import _build
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.refpack import PackedReference
    from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row
    from lamsa_tpu_torch.ops.traceback_row import traceback_row
    from lamsa_tpu_torch.pipeline.aln import Aligner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA refusals do not apply")
    codes = np.random.default_rng(1).integers(0, 4, 2000).astype(np.uint8)
    ref = PackedReference(names=["c"], offsets=np.array([0, 2000]),
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    with pytest.raises(RuntimeError, match="cuda"):
        Aligner(ref, KmerIndex.build(codes, 13), device="cuda")

    meta = dict(dtype=torch.int32, device="meta")
    v = torch.empty(4, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        banded_sw_row(torch.empty((4, 128), **meta),
                      torch.empty((4, 256), **meta), v, v, v, v,
                      match=1, mismatch=3, gapo=2, gape=1)
    with pytest.raises(ValueError, match="no kernel"):
        traceback_row(torch.empty((4, 32, 128), **meta), v, v, v)
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build()


def test_aligner_refuses_an_index_of_the_jax_package():
    """The port tells its own index classes apart with isinstance; an
    index object of the JAX package is refused, not seeded as the wrong
    kind."""
    from lamsa_tpu.index.kmer import KmerIndex as JaxKmerIndex
    from lamsa_tpu_torch.io.refpack import PackedReference
    from lamsa_tpu_torch.pipeline.aln import Aligner

    codes = np.random.default_rng(2).integers(0, 4, 2000).astype(np.uint8)
    ref = PackedReference(names=["c"], offsets=np.array([0, 2000]),
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    with pytest.raises(TypeError, match="lamsa_tpu.index.kmer.KmerIndex"):
        Aligner(ref, JaxKmerIndex.build(codes, 13), device="cpu")
