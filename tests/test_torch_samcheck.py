"""The SAM validator's copy (lamsa_tpu_torch/io/samcheck.py) on the
port's own SAM (--device cpu): no findings on tests/test_samcheck.py's
noisy SV world and its multi-chromosome translocation world, whose
records also equal the JAX package's CPU engine's byte for byte (the
port's first multi-sequence world on the CPU)."""

import dataclasses

import numpy as np
import torch

from lamsa_tpu import sim
from lamsa_tpu.io.sam import format_sam_record as jax_format
from lamsa_tpu.pipeline.aln import Aligner as JaxAligner
from lamsa_tpu_torch.io.sam import format_sam_record
from lamsa_tpu_torch.io.samcheck import validate_batch
from lamsa_tpu_torch.ops.testing import port_world
from lamsa_tpu_torch.pipeline.aln import Aligner
from tests.test_e2e import CFG, make_ref

torch.set_num_threads(1)


def _port(ref, idx, cfg, reads):
    pref, pidx, pcfg = port_world(ref, idx, cfg)
    return pref, Aligner(pref, pidx, pcfg, device="cpu").align_batch(reads)


def test_validator_clean_on_noisy_sv_world():
    rng = np.random.default_rng(11)
    genome, ref, idx = make_ref(rng, 300000)
    cfg = dataclasses.replace(CFG, report_secondary=True, emit_md=True)
    reads = sim.simulate_reads(rng, genome, 48, read_len=(500, 4000),
                               sub=0.02, ins=0.04, dele=0.04,
                               sv_fraction=0.5, name_prefix="v")
    pref, out = _port(ref, idx, cfg, reads)
    errs = validate_batch(out, pref)
    assert errs == [], "\n".join(errs)
    assert sum(1 for recs in out if len(recs) > 1) >= 5


def test_validator_clean_on_multichrom_translocations():
    rng = np.random.default_rng(12)
    genome, ref, idx = make_ref(rng, 200000, n_seqs=4)
    reads = sim.simulate_reads(rng, genome, 24, read_len=(800, 3000),
                               sub=0.01, ins=0.03, dele=0.03,
                               sv_fraction=1.0, name_prefix="t")
    pref, out = _port(ref, idx, CFG, reads)
    errs = validate_batch(out, pref)
    assert errs == [], "\n".join(errs)
    got = [format_sam_record(r) for recs in out for r in recs]
    want = [jax_format(r) for recs in
            JaxAligner(ref, idx, CFG).align_batch(reads) for r in recs]
    assert got == want
    assert len({ln.split("\t")[2] for ln in got}) > 1   # several chroms
