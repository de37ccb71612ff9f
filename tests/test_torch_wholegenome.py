"""The port's coordinate path past 2^31 against the JAX package, on the
CPU, exact equality: at config-4 scale (3.1e9 bp) reference positions
set bit 31 of a 32-bit word, and every place that carries one is held
here to the JAX function on seeded inputs:

- resolve_rows and seed_hits_fm on a 400 kb FM index whose sampled SA
  values are shifted into [2^31, 2^32 - 2^16) (both functions depend
  only on the arrays), seg quota and 1-edit tracks on;
- pack_desc / unpack_desc and the q / t window gather at t_base past
  2^31, on reference words of 3.1e9 codes in a sparse memory-mapped
  file (only the targets' pages are touched), and a whole row-pair
  chunk against JAX's (Pallas kernels in interpret mode); both pairs'
  chunks equal the same targets at low coordinates;
- chain_hits on hits whose rpos all lie in [2^31, 2^32);
- PackedReference.global_to_local and the SAM fields of records on
  config 4's 24 chromosomes;
- the whole-genome seeding rules (k, seg quota, 1-edit piece length,
  plain amin floor, re-seed sub-batches) at a total length of 3.1e9.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lamsa_tpu import sim
from lamsa_tpu.config import preset
from lamsa_tpu.index.fmindex import FmIndex
from lamsa_tpu.io.fasta import encode_seq
from lamsa_tpu.io.refpack import PackedReference
from lamsa_tpu.io.sam import SamRecord as JaxRecord
from lamsa_tpu.io.sam import format_sam_record as jax_format
from lamsa_tpu.ops import banded_sw as jbs
from lamsa_tpu.ops import banded_sw_pallas, traceback_pallas
from lamsa_tpu.ops import fm as jfm
from lamsa_tpu.ops.chain import chain_hits as jax_chain_hits
from lamsa_tpu.pipeline import aln as jax_aln
from lamsa_tpu.pipeline.seeding import make_qpos_grid
from lamsa_tpu.pipeline.seeding import seed_hits_fm as jax_seed_hits_fm
from lamsa_tpu.utils.timers import GLOBAL as JAX_STATS
from lamsa_tpu_torch.config import ScoreParams
from lamsa_tpu_torch.io.refpack import PackedReference as PortReference
from lamsa_tpu_torch.io.sam import SamRecord, format_sam_record
from lamsa_tpu_torch.ops import fm, wire
from lamsa_tpu_torch.ops.chain import chain_hits
from lamsa_tpu_torch.ops.dp_chain import dp_tb_adiag_gather, dp_tb_gather
from lamsa_tpu_torch.ops.testing import (SIGN_LINE, make_high_chunk,
                                         port_world)
from lamsa_tpu_torch.pipeline import aln as port_aln
from lamsa_tpu_torch.pipeline.seeding import seed_hits_fm
from lamsa_tpu_torch.utils.timers import GLOBAL as STATS

torch.set_num_threads(1)

GENOME = 3_100_000_000                  # config 4 (BASELINE.md)
N_CHROM = 24
S = ScoreParams(match=1, mismatch=3, gap_open=2, gap_ext=1, zdrop=100)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _i64(x):
    return np.asarray(x).astype(np.int64)


# ------------------------------------------------- FM resolve and seeding

@pytest.fixture(scope="module")
def fm400k():
    genome = sim.random_genome(np.random.default_rng(42), 400_000)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    return genome, codes, FmIndex.build(codes)


def _shifted(fmi, shift):
    """Both packages' device arrays of fmi with every sampled SA value
    plus shift."""
    hi = dataclasses.replace(fmi, ssa_pos=(fmi.ssa_pos.astype(np.uint64)
                                           + shift).astype(np.uint32))
    return jfm.device_arrays(hi), fm.fm_device_state(hi, "cpu")


SHIFTS = [SIGN_LINE, 2**32 - 2**16 - 400_001]


@pytest.mark.parametrize("shift", SHIFTS, ids=["at_2^31", "near_2^32"])
def test_resolve_rows_past_sign_line_matches_jax(fm400k, shift):
    _genome, codes, fmi = fm400k
    jdev, st = _shifted(fmi, shift)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, fmi.n + 1, (6, 300))
    rows[0, :3] = [0, fmi.primary, fmi.n]
    valid = rng.random(rows.shape) < 0.9
    want = np.asarray(jfm.resolve_rows(jnp.asarray(rows, jnp.uint32),
                                       jnp.asarray(valid), jdev,
                                       fmi.sa_rate))
    got = fm.resolve_rows(_t(rows), torch.from_numpy(valid), st,
                          fmi.sa_rate).numpy()
    np.testing.assert_array_equal(got, _i64(want))
    assert (got[valid & (rows != fmi.primary)] >= SIGN_LINE - fmi.n - 1) \
        .all()


@pytest.mark.parametrize("shift", SHIFTS, ids=["at_2^31", "near_2^32"])
def test_seed_hits_fm_past_sign_line_matches_jax(fm400k, shift):
    """Both strands, seg quota and 1-edit tracks: the packed two-key sort
    and the strided quota sampling on rpos past 2^31."""
    _genome, codes, fmi = fm400k
    jdev, st = _shifted(fmi, shift)
    rng = np.random.default_rng(2)
    B, L, k = 4, 1200, 13
    reads = np.full((B, L), 4, np.int64)
    lens = rng.integers(900, L + 1, B)
    for b in range(B):
        s0 = int(rng.integers(0, len(codes) - L))
        r = codes[s0:s0 + lens[b]].astype(np.int64)
        mut = rng.random(lens[b]) < 0.06
        r[mut] = rng.integers(0, 4, int(mut.sum()))
        reads[b, :lens[b]] = r if b % 2 == 0 else (3 - r)[::-1]
    grid = make_qpos_grid(L, k, 5)
    kw = dict(k=k, cands_per_seed=8, max_hits=256, sa_rate=fmi.sa_rate,
              seg_quota=8, sub1_cands=2, sub1_k=k + 2)
    want = jax_seed_hits_fm(jnp.asarray(reads, jnp.int32),
                            jnp.asarray(lens, jnp.int32),
                            jnp.asarray(grid), jdev, **kw)
    got = seed_hits_fm(_t(reads), _t(lens), _t(grid), st, **kw)
    for name in ("qpos", "rpos", "strand", "valid"):
        np.testing.assert_array_equal(_i64(got[name].numpy()),
                                      _i64(want[name]), err_msg=name)
    v = got["valid"].numpy()
    assert v.any() and (got["rpos"].numpy()[v] >= SIGN_LINE - fmi.n).all()


# ----------------------------------------- descriptors and window gathers

@pytest.fixture(scope="module")
def high_ref(tmp_path_factory):
    """Reference words of 3.1e9 codes in a sparse file: zero words
    (code 0) except the patches a test writes."""
    path = tmp_path_factory.mktemp("wg") / "ref_words.bin"
    n_words = (GENOME + 7) // 8
    with open(path, "wb") as fh:
        fh.truncate(4 * n_words)
    return np.memmap(path, np.int32, "r+", shape=(n_words,))


@pytest.fixture
def jax_interpret_kernels(monkeypatch):
    """JAX's fused chunk with its Pallas kernels in interpret mode."""
    monkeypatch.setattr(banded_sw_pallas, "banded_sw_pallas",
                        functools.partial(banded_sw_pallas.banded_sw_pallas,
                                          interpret=True))
    monkeypatch.setattr(traceback_pallas, "traceback_pallas",
                        functools.partial(traceback_pallas.traceback_pallas,
                                          interpret=True))


def _chunk(high_ref, M, W, K, seed):
    flat, patches, desc, low_ref, low_desc = make_high_chunk(
        np.random.default_rng(seed), GENOME, M, W, K)
    for w0, p in patches:
        high_ref[w0:w0 + len(p)] = p
    return flat, desc, low_ref, low_desc


def test_desc_and_windows_past_sign_line_match_jax(high_ref):
    M, W, K = 512, 256, 6
    flat, desc, low_ref, low_desc = _chunk(high_ref, M, W, K, 3)
    tb = desc[:, 1].view(np.uint32).astype(np.int64)
    assert tb.min() == SIGN_LINE + 8 and tb.max() >= GENOME - M
    got = wire.unpack_desc(torch.from_numpy(desc))
    want = jbs.unpack_desc(jnp.asarray(desc))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), _i64(w))
    np.testing.assert_array_equal(got[3].numpy(), tb)
    win = wire.gather_windows(torch.from_numpy(flat),
                              torch.from_numpy(high_ref), *got[:8], M=M, W=W)
    jwin = jbs.gather_windows(jnp.asarray(flat), jnp.asarray(high_ref),
                              *want[:8], M=M, W=W)
    low_fields = wire.unpack_desc(torch.from_numpy(low_desc))[:8]
    low = wire.gather_windows(torch.from_numpy(flat),
                              torch.from_numpy(low_ref), *low_fields,
                              M=M, W=W)
    for g, w, lw in zip(win, jwin, low):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), lw.numpy())
    # every target code was gathered (no lane was lost to a wrap)
    n = got[6].numpy()
    assert int((win[1].numpy() < 5).sum()) == int(n.sum())


def test_row_chunk_past_sign_line_matches_jax(high_ref,
                                              jax_interpret_kernels):
    M, W, K = 128, 128, 4
    flat, desc, low_ref, low_desc = _chunk(high_ref, M, W, K, 4)
    want = np.asarray(jbs._dp_tb_fused_gather(
        jnp.asarray(flat), jnp.asarray(high_ref), jnp.asarray(desc), M=M,
        W=W, match=S.match, mismatch=S.mismatch, gapo=S.gap_open,
        gape=S.gap_ext, zdrop=S.zdrop))
    got = dp_tb_gather(torch.from_numpy(flat), torch.from_numpy(high_ref),
                       torch.from_numpy(desc), M=M, W=W, scores=S,
                       zdrop=S.zdrop).numpy()
    np.testing.assert_array_equal(got, want)


def test_both_pairs_past_sign_line_equal_low_coordinates(high_ref):
    M, W, K = 256, 256, 8
    flat, desc, low_ref, low_desc = _chunk(high_ref, M, W, K, 5)
    fl = torch.from_numpy(flat)
    hi = (torch.from_numpy(high_ref), torch.from_numpy(desc))
    lo = (torch.from_numpy(low_ref), torch.from_numpy(low_desc))
    row = [dp_tb_gather(fl, r, d, M=M, W=W, scores=S, zdrop=S.zdrop)
           for r, d in (hi, lo)]
    adiag = [dp_tb_adiag_gather(fl, r, d[:K].contiguous(), M=M, W=W,
                                scores=S) for r, d in (hi, lo)]
    assert torch.equal(row[0], row[1])
    assert torch.equal(adiag[0], adiag[1])


# ------------------------------------------------------------- chaining

def test_chain_hits_past_sign_line_matches_jax():
    """Sorted hits on colinear runs (with drift, strand flips, invalid
    lanes and backward jumps) whose rpos all lie in [2^31, 2^32)."""
    rng = np.random.default_rng(6)
    B, H = 6, 160
    qpos = np.sort(rng.integers(0, 9000, (B, H)), axis=1)
    base = rng.integers(SIGN_LINE, 2**32 - 20_000, (B, 1))
    base[0] = SIGN_LINE
    base[1] = 2**32 - 10_001
    jump = np.where(np.arange(H) >= H // 2, rng.integers(-5000, 5000, (B, 1)),
                    0)
    rpos = base + qpos + rng.integers(-30, 30, (B, H)) + jump
    rpos = np.clip(rpos, SIGN_LINE, 2**32 - 1)
    strand = (rng.random((B, H)) < 0.15).astype(np.int64)
    valid = rng.random((B, H)) < 0.92
    order = np.lexsort((rpos, qpos, strand), axis=1)
    qpos, rpos, strand, valid = (np.take_along_axis(a, order, axis=1)
                                 for a in (qpos, rpos, strand, valid))
    kw = dict(weight=13, lookback=32, max_dist=2000, diag_slack=100)
    jf, jp = jax_chain_hits(jnp.asarray(qpos, jnp.int32),
                            jnp.asarray(rpos, jnp.uint32),
                            jnp.asarray(strand, jnp.int32),
                            jnp.asarray(valid), **kw)
    f, p = chain_hits(_t(qpos), _t(rpos), _t(strand),
                      torch.from_numpy(valid), **kw)
    np.testing.assert_array_equal(f.numpy(), _i64(jf))
    np.testing.assert_array_equal(p.numpy(), _i64(jp))
    assert (f.numpy() > 13 * 5).any()                  # chains formed


# ------------------------------------------------ chromosomes and SAM POS

def test_global_to_local_and_sam_on_config4_chromosomes():
    per = GENOME // N_CHROM
    names = [f"chr{c + 1}" for c in range(N_CHROM)]
    offsets = np.arange(N_CHROM + 1, dtype=np.int64) * per
    empty = np.zeros(0, np.uint8)
    jref = PackedReference(names=names, offsets=offsets, codes=empty,
                           amb_runs=np.zeros((0, 2), np.int64))
    pref = PortReference(names=names, offsets=offsets, codes=empty,
                         amb_runs=np.zeros((0, 2), np.int64))
    assert pref.total_len == jref.total_len == per * N_CHROM
    rng = np.random.default_rng(7)
    pos = np.concatenate([rng.integers(0, pref.total_len, 400),
                          offsets[16:] - 1, offsets[16:], [SIGN_LINE - 1,
                                                           SIGN_LINE]])
    pos = pos[pos < pref.total_len]
    for p in pos.tolist():
        assert pref.global_to_local(p) == jref.global_to_local(p)
        length = int(rng.integers(1, 20_000))
        assert pref.crosses_boundary(p, length) == \
            jref.crosses_boundary(p, length)
    sid, local = pref.global_to_local(SIGN_LINE + 12_345)
    assert names[sid] == "chr17"
    fields = dict(qname="r", flag=16, rname=names[sid], pos=local, mapq=60,
                  cigar=np.array([(500 << 4) | 0], np.uint32), seq="A" * 500,
                  qual=None, tags={"NM": 0, "AS": 500})
    assert format_sam_record(SamRecord(**fields)) == \
        jax_format(JaxRecord(**fields))


# --------------------------------------------------- whole-genome rules

class _Big:
    """A reference that reports config 4's total length."""

    @property
    def total_len(self) -> int:
        return GENOME


class _JaxBig(_Big, PackedReference):
    pass


class _PortBig(_Big, PortReference):
    pass


def test_seeding_rules_at_config4_length(fm400k, monkeypatch):
    """At 3.1e9 bp both packages choose k = 16, the 1-edit piece length
    21, the seg quota max_hits // 32 on every seeding call, the plain
    amin floor, and the same reads to re-seed: the seeding calls of a
    28%-error batch agree call by call."""
    genome, codes, fmi = fm400k
    cfg = preset("ont")
    fields = dict(names=[genome[0].name],
                  offsets=np.array([0, len(codes)], np.int64), codes=codes,
                  amb_runs=np.zeros((0, 2), np.int64))
    own_ref, own_fmi, own_cfg = port_world(PortReference(**fields), fmi, cfg)
    a = port_aln.Aligner(_PortBig(**fields), own_fmi, own_cfg, device="cpu")
    j = jax_aln.Aligner(_JaxBig(**fields), fmi, cfg)
    assert a.k == j.k == 16 and a._quota_on()
    assert a._sub1_k() == j._sub1_k() == 21
    lens = np.array([1000, 10_000, 40_000])
    np.testing.assert_array_equal(a._amin_eff(lens),
                                  [cfg.adaptive_seed_min_anchors] * 3)

    seen = {"port": [], "jax": []}

    def spy(name, real):
        def f(*args, **kw):
            seen[name].append((kw["seg_quota"], kw["sub1_k"],
                               bool(kw["sub1_cands"])))
            return real(*args, **kw)
        return f

    monkeypatch.setattr(port_aln, "seed_hits_fm",
                        spy("port", port_aln.seed_hits_fm))
    monkeypatch.setattr(jax_aln, "_seed_chain_packed_fm",
                        spy("jax", jax_aln._seed_chain_packed_fm))
    reads = sim.simulate_reads(np.random.default_rng(8), genome, 6,
                               read_len=(1500, 2500), sub=0.15, ins=0.07,
                               dele=0.06, name_prefix="e28")
    codes = [np.frombuffer(encode_seq(r.seq), np.uint8) for r in reads]
    L = a._bucket_len(max(len(c) for c in codes))
    offs = np.concatenate([[0], np.cumsum([len(c) for c in codes])])
    words = torch.from_numpy(wire.pack_codes_words(np.concatenate(codes)))
    STATS.reset()
    JAX_STATS.reset()
    a._seed_and_chain(codes, list(range(len(codes))), L, {a.device: words},
                      offs)
    j._seed_and_chain(codes, list(range(len(codes))), L)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == (cfg.max_hits_per_read // 32, 0, False)
    assert (cfg.max_hits_per_read // 32, 21, True) in seen["port"]
    assert STATS.counters["seed_densified_reads"] == \
        JAX_STATS.counters["seed_densified_reads"] > 0
