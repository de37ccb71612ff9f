"""Several processes (lamsa_tpu_torch/parallel/multihost.py) over
torch.distributed's gloo backend: batch ownership and the ordered SAM
merge in one process, and in two spawned worker processes that import
no JAX: the merge of skewed blobs, and a full alignment whose merged SAM
equals the one-process run (tests/test_multihost.py's cases)."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def test_single_process_merge_identity():
    from lamsa_tpu_torch.parallel.multihost import (initialize,
                                                    merge_sam_shards,
                                                    my_read_slice)
    initialize(None, 1, 0)                      # one process: nothing to do
    assert not dist.is_initialized()
    blobs = [b"batch0", b"batch1"]
    assert merge_sam_shards(blobs) == blobs
    assert my_read_slice(0) and my_read_slice(1)


def test_gloo_is_available():
    assert dist.is_available() and dist.is_gloo_available()


_PRELUDE = """
    import os, sys
    sys.path.insert(0, {repo!r})
    import torch
    torch.set_num_threads(1)
    from lamsa_tpu_torch.parallel.multihost import (initialize,
        merge_sam_shards, my_read_slice)
    pid = int(sys.argv[1])
    initialize("127.0.0.1:{port}", 2, pid)
"""

_MERGE = _PRELUDE + """
    # each process owns alternating batches; 4 batches in all
    mine = [f"batch{{i}}-p{{pid}}".encode()
            for i in range(4) if my_read_slice(i)]
    merged = merge_sam_shards(mine)
    if pid == 0:
        got = [m.decode() for m in merged]
        want = [f"batch{{i}}-p{{i % 2}}" for i in range(4)]
        assert got == want, (got, want)
        print("MERGE_OK")
    else:
        assert merged is None
    # unequal batch counts (5 over 2), one large blob among tiny and
    # empty ones: each round pads to its own longest blob only
    blobs = [b"x" * (200_000 if i == 2 else (0 if i == 3 else 7 + i))
             for i in range(5)]
    merged2 = merge_sam_shards([blobs[i] for i in range(5)
                                if my_read_slice(i)])
    if pid == 0:
        assert merged2 == blobs, [len(m) for m in merged2]
        print("SKEW_OK")
    else:
        assert merged2 is None
    assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "lamsa_tpu" or m.startswith("lamsa_tpu.")]
"""

_ALN = _PRELUDE + """
    import numpy as np
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.config import AlignConfig, ScoreParams
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.io.refpack import PackedReference
    from lamsa_tpu_torch.io.sam import format_sam_record
    from lamsa_tpu_torch.pipeline.aln import Aligner

    # the same seeded world in both processes
    rng = np.random.default_rng(1234)
    genome = sim.random_genome(rng, 30000)
    chunks = [np.frombuffer(encode_seq(g.seq), np.uint8) for g in genome]
    offs = np.zeros(len(genome) + 1, np.int64)
    offs[1:] = np.cumsum([len(c) for c in chunks])
    ref = PackedReference(names=[g.name for g in genome], offsets=offs,
                          codes=np.concatenate(chunks),
                          amb_runs=np.zeros((0, 2), np.int64))
    idx = KmerIndex.build(ref.codes, 13)
    reads = sim.simulate_reads(rng, genome, 12, read_len=(400, 1000),
                               sv_fraction=0.3)
    aligner = Aligner(ref, idx, AlignConfig(scores=ScoreParams(),
                                            seed_step=10), device="cpu")
    BS = 4
    batches = [reads[i:i + BS] for i in range(0, len(reads), BS)]
    mine = [aligner.align_batch(b) for i, b in enumerate(batches)
            if my_read_slice(i)]
    merged = merge_sam_shards(["".join(
        format_sam_record(r) + "\\n" for per_read in recs for r in per_read)
        .encode() for recs in mine])
    if pid == 0:
        with open(sys.argv[2], "wb") as fh:
            fh.write(b"".join(merged))
        print("ALN_MERGE_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_two(tmp_path, body, *extra):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(body.format(repo=REPO,
                                                  port=_free_port())))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return [subprocess.Popen([sys.executable, str(script), str(pid), *extra],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env) for pid in range(2)]


def _wait(procs, timeout=300):
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            pytest.fail(f"worker hung: {err[-800:]}")
        outs.append((p.returncode, out, err))
    for rc, _out, err in outs:
        assert rc == 0, err[-1500:]
    return outs


def test_two_process_distributed_merge(tmp_path):
    outs = _wait(_start_two(tmp_path, _MERGE))
    assert "MERGE_OK" in outs[0][1] and "SKEW_OK" in outs[0][1]


def test_two_process_full_alignment(tmp_path):
    """Each of two processes aligns its round-robin batches through the
    port's Aligner; process 0's merged SAM equals one process aligning
    every batch."""
    from lamsa_tpu_torch import sim
    from lamsa_tpu_torch.config import AlignConfig, ScoreParams
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.fasta import encode_seq
    from lamsa_tpu_torch.io.refpack import PackedReference
    from lamsa_tpu_torch.io.sam import format_sam_record
    from lamsa_tpu_torch.pipeline.aln import Aligner

    out = tmp_path / "merged.sam"
    procs = _start_two(tmp_path, _ALN, str(out))
    # meanwhile, the one-process run on the same world
    rng = np.random.default_rng(1234)
    genome = sim.random_genome(rng, 30000)
    codes = np.concatenate([np.frombuffer(encode_seq(g.seq), np.uint8)
                            for g in genome])
    ref = PackedReference(names=[g.name for g in genome],
                          offsets=np.array([0, len(codes)], np.int64),
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    reads = sim.simulate_reads(rng, genome, 12, read_len=(400, 1000),
                               sv_fraction=0.3)
    recs = Aligner(ref, KmerIndex.build(codes, 13),
                   AlignConfig(scores=ScoreParams(), seed_step=10),
                   device="cpu").align_batch(reads)
    want = "".join(format_sam_record(r) + "\n" for rs in recs for r in rs)
    outs = _wait(procs)
    assert "ALN_MERGE_OK" in outs[0][1]
    assert out.read_text() == want
