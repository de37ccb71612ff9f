"""The PyTorch port imports no JAX, reuses only the JAX package's
JAX-free modules, and never runs on the CPU when CUDA was asked for."""

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
    "lamsa_tpu_torch.ops.banded_sw_adiag",
    "lamsa_tpu_torch.ops.banded_sw_row", "lamsa_tpu_torch.ops.chain",
    "lamsa_tpu_torch.ops.dp_chain", "lamsa_tpu_torch.ops.fm",
    "lamsa_tpu_torch.ops.testing",
    "lamsa_tpu_torch.ops.traceback_adiag",
    "lamsa_tpu_torch.ops.traceback_row", "lamsa_tpu_torch.ops.wire",
    "lamsa_tpu_torch.pipeline.aln",
    "lamsa_tpu_torch.pipeline.extend", "lamsa_tpu_torch.pipeline.seeding",
    "lamsa_tpu_torch.pipeline.state",
]
REUSED_MODULES = [
    "lamsa_tpu.config", "lamsa_tpu.io.fasta", "lamsa_tpu.io.refpack",
    "lamsa_tpu.io.sam", "lamsa_tpu.index.kmer", "lamsa_tpu.index.fmindex",
    "lamsa_tpu.native", "lamsa_tpu.sim", "lamsa_tpu.eval",
    "lamsa_tpu.pipeline.skeleton", "lamsa_tpu.ops.oracle",
    "lamsa_tpu.ops.traceback", "lamsa_tpu.utils.timers", "lamsa_tpu.cli",
]


def _run(code, *args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("modules", [PORT_MODULES, REUSED_MODULES],
                         ids=["port", "reused"])
def test_modules_import_without_jax(modules):
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "    assert 'jax' not in sys.modules, m\n"
            "print('ok')\n")
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_cli_index_and_aln_on_cpu_without_jax(tmp_path):
    """index + aln --device cpu through the port's CLI in a fresh
    process: SAM comes out, and jax is never imported."""
    from lamsa_tpu import sim
    from lamsa_tpu.io.fasta import write_fasta, write_fastq
    rng = np.random.default_rng(7)
    genome = sim.random_genome(rng, 30000)
    reads = sim.simulate_reads(rng, genome, 4, read_len=(400, 900))
    fa, fq = str(tmp_path / "g.fa"), str(tmp_path / "r.fq")
    write_fasta(fa, genome)
    write_fastq(fq, reads)
    code = ("import sys\n"
            "from lamsa_tpu_torch.cli import main\n"
            "rc = main(['index', '-k', '13', sys.argv[1]])\n"
            "rc = rc or main(['aln', '--device', 'cpu', '-o', sys.argv[3],"
            " sys.argv[1], sys.argv[2]])\n"
            "assert 'jax' not in sys.modules\n"
            "sys.exit(rc)\n")
    out = str(tmp_path / "o.sam")
    r = _run(code, fa, fq, out)
    assert r.returncode == 0, r.stderr
    recs = [ln for ln in open(out) if not ln.startswith("@")]
    assert len(recs) >= 4
    assert all(not int(ln.split("\t")[1]) & 4 for ln in recs)
    # options whose machinery is not ported are refused
    for extra in (["-d", "2"], ["--num-shards", "2", "-o", out],
                  ["--resume", "-o", out]):
        r = _run("import sys\nfrom lamsa_tpu_torch.cli import main\n"
                 "sys.exit(main(sys.argv[1:]))\n", "aln", "--device", "cpu",
                 *extra, fa, fq)
        assert r.returncode == 2 and "not ported" in r.stderr, extra


def test_cuda_requests_never_run_on_cpu():
    """Without CUDA, asking for it raises; the kernel wrappers launch or
    raise for any tensor that is not on the CPU."""
    from lamsa_tpu.index.kmer import KmerIndex
    from lamsa_tpu.io.refpack import PackedReference
    from lamsa_tpu_torch import _build
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
