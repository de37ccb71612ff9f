"""The FM-index backend of the PyTorch port against the JAX package, on
the CPU. Exact equality everywhere (integer outputs):

- ops/fm.py: the SWAR popcount against numpy; edit1_tracks, the device
  state, backward_search, backward_search_1edit and resolve_rows
  against lamsa_tpu.ops.fm and the host FmIndex queries (a 30 kb genome
  with a tandem repeat, sa_rate 4 and 16, N-poisoned windows);
- seed_hits_fm against the JAX function: plain, seg_quota, the 1-edit
  tracks at sub1_k == k and > k, and truncation at a small max_hits;
- the FM Aligner: SAM byte-identical to the JAX CPU engine on noisy and
  SV reads, and on the 28%-error ont world where the adaptive re-seed
  with 1-edit tracks fires (chunked retry = unchunked) but for the AS
  of records whose 1-edit anchors carry a substituted base, which the
  port scores base by base (tests/sam_rescore.py; a 19%-error world
  holds that case alone); the >1 Gb seg-quota rules; the CLI's index
  --fm + aln against the JAX CLI.

Each side gets its own FmIndex and reference, built from the same codes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lamsa_tpu import sim
from lamsa_tpu.config import preset
from lamsa_tpu.index.fmindex import FmIndex
from lamsa_tpu.io.fasta import encode_seq
from lamsa_tpu.io.refpack import PackedReference
from lamsa_tpu.io.sam import format_sam_record as jax_format
from lamsa_tpu.ops import fm as jfm
from lamsa_tpu.pipeline.aln import Aligner as JaxAligner
from lamsa_tpu.pipeline.seeding import make_qpos_grid
from lamsa_tpu.pipeline.seeding import seed_hits_fm as jax_seed_hits_fm
from lamsa_tpu_torch.index.fmindex import FmIndex as PortFmIndex
from lamsa_tpu_torch.io.refpack import PackedReference as PortReference
from lamsa_tpu_torch.io.sam import format_sam_record
from lamsa_tpu_torch.ops import fm
from lamsa_tpu_torch.ops.testing import port_world
from lamsa_tpu_torch.pipeline import aln as port_aln
from lamsa_tpu_torch.pipeline.aln import Aligner
from lamsa_tpu_torch.pipeline.seeding import seed_hits_fm
from lamsa_tpu_torch.utils.timers import GLOBAL as STATS
from sam_rescore import as_departures, as_faults

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module", params=[4, 16], ids=["sa4", "sa16"])
def world(request):
    """30 kb genome: random, with a 40 bp unit tiled 30 times (intervals
    wider than the candidate count), at the given sa_rate."""
    rng = np.random.default_rng(9)
    unit = rng.integers(0, 4, 40).astype(np.uint8)
    codes = np.concatenate([rng.integers(0, 4, 14000).astype(np.uint8),
                            np.tile(unit, 30),
                            rng.integers(0, 4, 14800).astype(np.uint8)])
    fmi = FmIndex.build(codes, sa_rate=request.param)
    own = PortFmIndex.build(codes, sa_rate=request.param)
    return codes, fmi, jfm.device_arrays(fmi), fm.fm_device_state(own, "cpu")


def _windows(rng, codes, B, S, k):
    win = np.zeros((B, S, k), np.int64)
    starts = rng.integers(0, len(codes) - k, (B, S))
    starts[0, :4] = 14000 + np.arange(4) * 3          # inside the repeat
    for b in range(B):
        for s_ in range(S):
            win[b, s_] = codes[starts[b, s_]:starts[b, s_] + k]
    win[0, 5, 3] = 4                                  # N-poisoned
    win[1, 2, k - 1] = 4
    ok = (win < 4).all(axis=2)
    ok[2, 1] = False                                  # invalid, clean
    return win, ok


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(1)
    edge = [0, 0xFFFFFFFF, 0x80000000, 0x55555555, 0xAAAAAAAA, 1]
    edge += [1 << b for b in range(32)]
    x = np.concatenate([np.asarray(edge, np.uint64),
                        rng.integers(0, 1 << 32, 4000, dtype=np.uint64)])
    want = np.array([bin(int(v)).count("1") for v in x], np.int64)
    got = fm.popcount32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kinds", ["s", "sdi"])
def test_edit1_tracks_copy_equals_jax(kinds):
    for k in (11, 16, 19):
        for a, b in zip(fm.edit1_tracks(k, kinds), jfm.edit1_tracks(k, kinds)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_fm_device_state_matches_device_arrays(world):
    _codes, fmi, jdev, st = world
    for name in ("blk", "mblk", "ssa_pos"):
        assert st[name].dtype == torch.int32
        np.testing.assert_array_equal(st[name].numpy().view(np.uint32),
                                      np.asarray(jdev[name]), err_msg=name)
    np.testing.assert_array_equal(st["C"].numpy(), _np(jdev["C"]))
    assert int(st["primary"]) == int(jdev["primary"]) == fmi.primary
    assert int(st["n_rows"]) == int(jdev["n_rows"]) == fmi.n + 1


def test_backward_search_matches_jax_and_host(world):
    codes, fmi, jdev, st = world
    k = 9
    win, ok = _windows(np.random.default_rng(2), codes, 4, 8, k)
    lo, hi = fm.backward_search(_t(win), torch.from_numpy(ok), st, k)
    jlo, jhi = jfm.backward_search(win.astype(np.int32), ok, jdev, k)
    np.testing.assert_array_equal(lo.numpy(), _np(jlo))
    np.testing.assert_array_equal(hi.numpy(), _np(jhi))
    for b in range(4):
        for s_ in range(8):
            want = fmi.backward_search(win[b, s_].astype(np.uint8)) \
                if ok[b, s_] else (0, 0)
            assert (lo[b, s_].item(), hi[b, s_].item()) == want, (b, s_)
    assert (hi - lo).max() > 8                         # the repeat


@pytest.mark.parametrize("kinds", ["s", "sdi"])
def test_backward_search_1edit_matches_jax(world, kinds):
    codes, _fmi, jdev, st = world
    k = 9
    win, ok = _windows(np.random.default_rng(3), codes, 3, 6, k)
    win[:, :, 4] ^= 1                                  # one substitution
    lo, hi = fm.backward_search_1edit(_t(win), torch.from_numpy(ok), st, k,
                                      kinds=kinds)
    jlo, jhi = jfm.backward_search_1edit(win.astype(np.int32), ok, jdev, k,
                                         kinds=kinds)
    np.testing.assert_array_equal(lo.numpy(), _np(jlo))
    np.testing.assert_array_equal(hi.numpy(), _np(jhi))
    assert (hi > lo).sum() >= 18                       # variants matched


def test_resolve_rows_matches_jax_and_host(world):
    _codes, fmi, jdev, st = world
    rng = np.random.default_rng(4)
    rows = np.concatenate([[0, fmi.primary, fmi.n, fmi.n - 1],
                           rng.integers(0, fmi.n + 1, 252)]).astype(np.int64)
    valid = rng.random(len(rows)) < 0.9
    valid[:4] = True
    pos = fm.resolve_rows(_t(rows), torch.from_numpy(valid), st, fmi.sa_rate)
    jpos = jfm.resolve_rows(rows.astype(np.uint32), valid, jdev, fmi.sa_rate)
    np.testing.assert_array_equal(pos.numpy(), _np(jpos))
    for i, r in enumerate(rows):
        want = fmi.resolve_row(int(r)) % (fmi.n + 1) if valid[i] else 0
        assert pos[i].item() == want, int(r)


SEED_CASES = {
    "plain": dict(),
    "quota1": dict(seg_quota=1),
    "quota16": dict(seg_quota=16),
    "sub1_k": dict(sub1_cands=2),
    "sub1_k13": dict(sub1_cands=2, sub1_k=13),
    "truncate": dict(max_hits=24),
}


@pytest.mark.parametrize("case", list(SEED_CASES))
def test_seed_hits_fm_matches_jax(world, case):
    """Reads from the genome on both strands, through the tandem repeat,
    with N codes and substitutions; exact equality of all four
    outputs."""
    codes, fmi, jdev, st = world
    rng = np.random.default_rng(5)
    k, L, B = 11, 256, 6
    reads = np.full((B, L), 4, np.int64)
    lens = np.array([256, 200, 230, 180, 256, 120], np.int64)
    for b in range(B):
        s0 = 13950 if b < 2 else int(rng.integers(0, len(codes) - 300))
        frag = codes[s0:s0 + lens[b]].astype(np.int64)
        if b % 2:
            frag = (3 - frag[::-1]) & 3
        frag[rng.integers(0, lens[b], 6)] ^= 2
        reads[b, :lens[b]] = frag
    reads[2, 50:53] = 4
    grid = make_qpos_grid(L, k, 7)
    kw = dict(k=k, cands_per_seed=8, max_hits=256, sa_rate=fmi.sa_rate)
    kw.update(SEED_CASES[case])
    want = jax_seed_hits_fm(reads.astype(np.int32), lens.astype(np.int32),
                            grid, jdev, **kw)
    got = seed_hits_fm(_t(reads), _t(lens), _t(grid), st, **kw)
    for name in ("qpos", "rpos", "strand", "valid"):
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]),
                                      err_msg=name)
    v = got["valid"].numpy()
    assert set(got["strand"].numpy()[v].tolist()) == {0, 1}
    if case == "truncate":
        assert v.all(axis=1).any()                     # a read saturated
    if case != "plain":                                # the branch acted
        plain = seed_hits_fm(_t(reads), _t(lens), _t(grid), st, k=k,
                             cands_per_seed=8, max_hits=256,
                             sa_rate=fmi.sa_rate)
        assert v.sum() != plain["valid"].sum().item()


# ----------------------------------------------------------- end to end

def _sam(out, fmt=format_sam_record):
    return [fmt(r) for recs in out for r in recs]


def _fm_ref(length, seed=42):
    genome = sim.random_genome(np.random.default_rng(seed), length)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    ref = PackedReference(names=[genome[0].name],
                          offsets=np.array([0, len(codes)], np.int64),
                          codes=codes, amb_runs=np.zeros((0, 2), np.int64))
    return genome, ref, FmIndex.build(codes)


@pytest.fixture(scope="module")
def fm400k():
    return _fm_ref(400_000)


def test_fm_noisy_and_sv_reads_sam_identical(fm400k):
    genome, ref, fmi = fm400k
    rng = np.random.default_rng(3)
    reads = sim.simulate_reads(rng, genome, 10, read_len=(500, 3000),
                               sub=0.01, ins=0.05, dele=0.04,
                               name_prefix="noisy")
    reads += sim.simulate_reads(rng, genome, 8, read_len=(1200, 2400),
                                sub=0.01, ins=0.04, dele=0.03,
                                sv_fraction=1.0, name_prefix="sv")
    cfg = preset("pacbio")
    want = _sam(JaxAligner(ref, fmi, cfg).align_batch(reads), jax_format)
    aligner = Aligner(*port_world(ref, fmi, cfg), device="cpu")
    assert aligner.seed_backend == "fm" and aligner.k == 13
    got = _sam(aligner.align_batch(reads))
    assert got == want
    assert sum("SA:Z:" in s for s in got) >= 4         # split alignments


def test_fm_28pct_error_ont_sam_identical(fm400k, monkeypatch):
    """The 28%-error ont world of tests/test_e2e.py: the adaptive re-seed
    runs with the 1-edit variant tracks, and the port's SAM equals the
    JAX engine's, with the retry chunked to its minimum sub-batch too,
    but for one departure (tests/sam_rescore.py): where a 1-edit anchor
    carries a substituted base, the port's AS is its CIGAR's score and
    the JAX package's is match + mismatch above it per such base."""
    genome, ref, fmi = fm400k
    reads = sim.simulate_reads(np.random.default_rng(7), genome, 12,
                               read_len=(1000, 3000), sv_fraction=0.2,
                               sub=0.15, ins=0.07, dele=0.06,
                               name_prefix="e28")
    cfg = preset("ont")
    want = _sam(JaxAligner(ref, fmi, cfg).align_batch(reads), jax_format)
    own = port_world(ref, fmi, cfg)
    STATS.reset()
    got = _sam(Aligner(*own, device="cpu").align_batch(reads))
    n_dense = STATS.counters.get("seed_densified_reads", 0)
    assert n_dense > 8                                 # chunks of 8 below
    n, bases = as_departures(got, want, ref, cfg.scores)
    print(f"AS departures from the JAX package: {n} records, {bases} "
          f"substituted anchor bases")
    assert bases <= STATS.counters.get("anchor_subs", 0)
    monkeypatch.setattr(port_aln, "_RETRY_BUDGET_ELEMS", 1)
    chunked = _sam(Aligner(*own, device="cpu").align_batch(reads))
    assert chunked == got


def test_substituted_anchor_base_is_scored(fm400k):
    """A 1-edit anchor that carries a substitution, in small: 6 reads at
    19% error under the GRCh38 FM cell's scores (1, 3, 5, 2) and the
    default re-seed (1-edit tracks, 2 rows each). The port's AS is its
    CIGAR re-scored against the genome on every record, NM and every
    other field equal the JAX package's, whose AS is match + mismatch
    higher per substituted anchor base, and finalize counts the bases
    in ``anchor_subs``."""
    from lamsa_tpu.config import AlignConfig, ScoreParams
    genome, ref, fmi = fm400k
    reads = sim.simulate_reads(np.random.default_rng(1), genome, 6,
                               read_len=(1500, 3000), sub=0.05, ins=0.07,
                               dele=0.07, name_prefix="s")
    cfg = AlignConfig(scores=ScoreParams(match=1, mismatch=3, gap_open=5,
                                         gap_ext=2), seed_step=10)
    assert cfg.seed_1edit_cands == 2
    want = _sam(JaxAligner(ref, fmi, cfg).align_batch(reads), jax_format)
    STATS.reset()
    got = _sam(Aligner(*port_world(ref, fmi, cfg), device="cpu")
               .align_batch(reads))
    assert STATS.counters["fm_1edit_tracks"] > 0       # the re-seed ran
    assert as_faults(got, ref, cfg.scores) == []
    n, bases = as_departures(got, want, ref, cfg.scores)
    assert n >= 1 and 0 < bases <= STATS.counters["anchor_subs"]


class _BigRef(PortReference):
    """A small reference that reports a whole-genome total length."""

    @property
    def total_len(self) -> int:
        return 2_000_000_000


def test_seg_quota_rules_above_1gb(fm400k, monkeypatch):
    genome, ref, fmi = fm400k
    ref, fmi, cfg = port_world(ref, fmi, preset("pacbio"))
    big = _BigRef(names=ref.names, offsets=ref.offsets, codes=ref.codes,
                  amb_runs=ref.amb_runs)
    lens = np.array([1000, 5000, 20000])
    a = Aligner(big, fmi, cfg, device="cpu")
    assert a.k == 16 and a._quota_on()
    np.testing.assert_array_equal(a._amin_eff(lens), [4, 4, 4])
    small = Aligner(ref, fmi, cfg, device="cpu")
    assert not small._quota_on()
    np.testing.assert_array_equal(small._amin_eff(lens), [4, 19, 78])

    seen = []
    real = port_aln.seed_hits_fm

    def spy(*args, **kw):
        seen.append(kw["seg_quota"])
        return real(*args, **kw)

    monkeypatch.setattr(port_aln, "seed_hits_fm", spy)
    read = sim.simulate_reads(np.random.default_rng(1), genome, 1,
                              read_len=(1500, 2000))
    a.align_batch(read)
    small.align_batch(read)
    assert seen[0] == cfg.max_hits_per_read // 32 == 16 and seen[-1] == 0


def test_cli_fm_index_and_aln_match_jax_cli(tmp_path):
    """index --fm and aln --device cpu through the port's CLI: the SAM
    body equals the JAX CLI's on the index the port wrote, and neither
    jax nor the JAX package is ever imported by the port."""
    from lamsa_tpu.io.fasta import write_fasta, write_fastq
    rng = np.random.default_rng(8)
    genome = sim.random_genome(rng, 40000)
    reads = sim.simulate_reads(rng, genome, 5, read_len=(400, 1500),
                               sv_fraction=0.4)
    fa, fq = str(tmp_path / "g.fa"), str(tmp_path / "r.fq")
    write_fasta(fa, genome)
    write_fastq(fq, reads)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    code = ("import sys\n"
            "from lamsa_tpu_torch.cli import main\n"
            "rc = main(['index', '--fm', sys.argv[1]])\n"
            "rc = rc or main(['aln', '--device', 'cpu', '-o', sys.argv[3],"
            " sys.argv[1], sys.argv[2]])\n"
            "assert 'jax' not in sys.modules\n"
            "assert not [m for m in sys.modules if m == 'lamsa_tpu'"
            " or m.startswith('lamsa_tpu.')]\n"
            "sys.exit(rc)\n")
    port_out, jax_out = str(tmp_path / "p.sam"), str(tmp_path / "j.sam")
    r = subprocess.run([sys.executable, "-c", code, fa, fq, port_out],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert FmIndex.exists(fa + ".lti")
    r = subprocess.run([sys.executable, "-m", "lamsa_tpu.cli", "aln", "-o",
                        jax_out, fa, fq], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr

    def body(p):
        return [ln for ln in open(p) if not ln.startswith("@")]
    assert len(body(port_out)) >= 5
    assert body(port_out) == body(jax_out)
