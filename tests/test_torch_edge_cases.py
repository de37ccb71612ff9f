"""Degenerate inputs through the port's Aligner (--device cpu) on one
device and on a mesh of three CPU entries, byte for byte against the
JAX package's CPU engine (the templates are tests/test_edge_cases.py and
the oversize unit of tests/test_e2e.py): reads shorter than k, all-N and
N-gapped reads, reads at the genome's two ends, the empty batch, fewer
reads than mesh entries, a read past the largest read-length bucket, an
interior gap past the largest DP bucket, and MD tags."""

import numpy as np
import pytest
import torch

from lamsa_tpu import sim
from lamsa_tpu.io.fasta import FastxRecord
from lamsa_tpu.io.sam import format_sam_record as jax_format
from lamsa_tpu.pipeline.aln import Aligner as JaxAligner
from lamsa_tpu_torch.io.sam import format_sam_record
from lamsa_tpu_torch.ops.testing import port_world
from lamsa_tpu_torch.pipeline.aln import Aligner
from lamsa_tpu_torch.utils.timers import GLOBAL as STATS
from tests.test_e2e import make_ref
from tests.test_edge_cases import CFG

torch.set_num_threads(1)

MESHES = {"one": None, "three": ["cpu"] * 3}


def _same_sam(ref, idx, cfg, reads, mesh):
    want = [jax_format(r) for recs in
            JaxAligner(ref, idx, cfg).align_batch(reads) for r in recs]
    pref, pidx, pcfg = port_world(ref, idx, cfg)
    STATS.reset()
    out = Aligner(pref, pidx, pcfg, device="cpu",
                  mesh=MESHES[mesh]).align_batch(reads)
    got = [format_sam_record(r) for recs in out for r in recs]
    assert len(out) == len(reads)
    assert got == want
    return out


@pytest.fixture(scope="module")
def genome50k():
    return make_ref(np.random.default_rng(0), 50000)


@pytest.mark.parametrize("md", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_degenerate_and_edge_reads(genome50k, mesh, md):
    genome, ref, idx = genome50k
    g = genome[0].seq
    frag = g[5000:5400]
    frag = frag[:100] + ("A" if frag[100] != "A" else "C") + frag[101:]
    reads = [
        FastxRecord(name="tiny", seq="ACGT"),             # shorter than k
        FastxRecord(name="empty", seq=""),
        FastxRecord(name="exact_k", seq=g[100:113]),      # == k
        FastxRecord(name="n_run", seq=g[2000:2200] + "N" * 50
                    + g[2250:2450]),                      # N gap inside
        FastxRecord(name="all_n", seq="N" * 300),
        FastxRecord(name="normal", seq=g[30000:30600]),
        FastxRecord(name="homopolymer", seq="A" * 250),
        FastxRecord(name="left_edge", seq=g[:400]),
        FastxRecord(name="right_edge", seq=g[-400:]),
        FastxRecord(name="mismatch", seq=frag),
    ]
    out = _same_sam(ref, idx, CFG.replace(emit_md=md), reads, mesh)
    assert out[0][0].flag & 4 and out[4][0].flag & 4
    assert out[7][0].pos == 0 and out[8][0].pos == 50000 - 400
    assert any("MD" in r.tags for recs in out for r in recs) == md


@pytest.mark.parametrize("mesh", list(MESHES))
def test_empty_batch_and_fewer_reads_than_entries(genome50k, mesh):
    genome, ref, idx = genome50k
    pref, pidx, pcfg = port_world(ref, idx, CFG)
    assert Aligner(pref, pidx, pcfg, device="cpu",
                   mesh=MESHES[mesh]).align_batch([]) == []
    g = genome[0].seq
    reads = [FastxRecord(name="a", seq=g[1000:1700]),
             FastxRecord(name="b", seq=g[9000:9900])]
    _same_sam(ref, idx, CFG, reads, mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_read_past_the_largest_read_bucket(mesh):
    genome, ref, idx = make_ref(np.random.default_rng(0), 60000)
    g = genome[0].seq
    cfg = CFG.replace(read_len_buckets=(512, 1024))
    out = _same_sam(ref, idx, cfg,
                    [FastxRecord(name="big", seq=g[1000:4000])], mesh)
    assert out[0][0].pos == 1000


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gap_past_the_largest_dp_bucket(mesh):
    """A chained interior gap longer than MAX_BUCKET_M (chain_max_dist
    raised so the chain links across it): the unit is split from its
    anchor (dp_oversize_unit_split) and the gap alone fits no bucket
    (dp_no_bucket_fallback)."""
    genome, ref, idx = make_ref(np.random.default_rng(77), 40000)
    g = genome[0].seq
    noise = sim.random_genome(np.random.default_rng(78), 5400)[0].seq
    read = FastxRecord(name="oversize", seq=g[:2000] + noise
                       + g[7400:9900])
    _same_sam(ref, idx, CFG.replace(chain_max_dist=8000), [read], mesh)
    assert STATS.counters.get("dp_oversize_unit_split", 0) >= 1
    assert STATS.counters.get("dp_no_bucket_fallback", 0) >= 1
