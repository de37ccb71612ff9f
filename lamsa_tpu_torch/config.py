# Copy of lamsa_tpu/config.py; only its import lines differ.
"""Configuration for the aligner.

Mirrors the reference CLI surface behaviorally (SURVEY.md section 1:
``lamsa aln [opts] <ref.fa> <reads.fq>`` with threads, seed length /
per-seed edits, scoring, band width, SV-size bound, read-type presets).
The reference's defaults are tagged [U] in SURVEY.md (unverifiable in this
environment — the mount was empty); values here are our own documented
defaults chosen to match the published algorithm description.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ScoreParams:
    """Affine-gap scoring, ksw conventions (SURVEY.md section 3.4).

    A gap of length L costs ``gap_open + L * gap_ext``.
    """

    match: int = 1
    mismatch: int = 3       # penalty (positive)
    gap_open: int = 5       # penalty (positive)
    gap_ext: int = 2        # penalty (positive)
    # Soft-clip penalty for end extension: extend to the read end only if
    # global-to-end score >= max-cell score - end_bonus (bwa-mem-style).
    end_bonus: int = 5
    # X-drop for extension termination (generous; band already limits work).
    zdrop: int = 100

    def as_tuple(self):
        return (self.match, self.mismatch, self.gap_open, self.gap_ext)


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """End-to-end aligner configuration.

    Seeding follows the reference's design point (SURVEY.md section 1
    stage 1: ~50 bp seeds matched with <= 3 edits) via the pigeonhole
    principle at maximum density: exact ``kmer``-length pieces matched
    against the index (pure gathers, XLA-friendly) every ``seed_step``
    bp, with sparse-DP chaining as the verification stage.
    """

    scores: ScoreParams = dataclasses.field(default_factory=ScoreParams)

    # --- seeding ---
    # The reference matched ~50 bp seeds allowing ~3 edits via GEM
    # (SURVEY.md section 1 stage 1). The TPU-native equivalent is the
    # pigeonhole bound taken to its density limit: exact `kmer`-length
    # pieces (50 // (3+1) ~= 13) sampled every `seed_step` bp, with
    # chaining playing the role of per-seed verification — a true locus
    # accumulates many co-linear piece hits while spurious loci don't.
    # Measured recall of this scheme (tests/test_e2e.py harsh-error
    # test, bench 15%-error section): part_recall 1.0 through 17% total
    # error (sub=0.08) at seed_step=10, the PacBio CLR regime.
    seed_step: int = 25         # seed piece spacing along the read
    kmer: int = 13              # exact piece length for pigeonhole matching
    max_hits_per_kmer: int = 64     # drop k-mers more frequent than this
    max_cands_per_seed: int = 16    # candidate loci kept per seed
    max_hits_per_read: int = 512    # static bound on chain input

    # Adaptive densification: reads whose best chain scores fewer than
    # this many anchors' worth are re-seeded on a half-step grid (the
    # >22%-error tail regime; 0 disables). See pipeline/aln.py
    # _seed_and_chain and the BASELINE.md round-4 error sweep.
    adaptive_seed_min_anchors: int = 4
    # On the FM backend the adaptive re-seed also searches every
    # piece's 1-edit variants (ops/fm.py backward_search_1edit — the
    # GEM ≤e-edit semantic, SURVEY.md §7.2a), keeping this many
    # candidate loci per variant track (0 disables; never used on the
    # exact-piece hot path).
    seed_1edit_cands: int = 2
    # Which edit families the variant tracks cover ('s' subs, 'd'
    # deletions, 'i' insertions). Subs-only measured best: indel
    # variants anchor on ±1-shifted diagonals, which conflicts with
    # exact-coordinate block building (ops/fm.py edit1_tracks note).
    seed_1edit_kinds: str = "s"
    # Second adaptive trigger: re-seed when any read stretch of this
    # many seed windows has NO candidate hit on either strand (a
    # missed small part leaves the score trigger blind; 0 disables).
    # 40 windows is ~1e-4 false-fire per stretch at the 15% design
    # point (pipeline/aln.py _seed_and_chain).
    adaptive_seed_gap_windows: int = 40

    # --- chaining (SURVEY.md section 3.3 sparse DP) ---
    chain_lookback: int = 32        # bounded predecessor scan window
    chain_max_dist: int = 5000      # max ref/read gap within one chain
    chain_diag_slack: int = 100     # max diagonal drift within one chain
    chain_min_score: int = 2        # min seeds' worth of score to keep chain
    max_chains_per_read: int = 8    # split parts bound (multi-chain keep)

    # --- SV classification (SURVEY.md section 1 stage 2) ---
    sv_min_size: int = 30           # smaller gaps handled inside one part
    sv_max_size: int = 100000       # reference jump beyond this -> transloc

    # --- extension / banded DP (SURVEY.md section 3.4) ---
    # Kernel bands are bucketed (pipeline/extend.BUCKETS: W in
    # {128, 256}); band_width acts as a MINIMUM band: instances route
    # only to buckets with W >= band_width, so -w > 128 forces the wide
    # band everywhere. Values > 256 are clamped with a warning (cli.py).
    band_width: int = 64

    # --- batching / parallelism ---
    batch_reads: int = 512          # reads per device batch
    read_len_buckets: tuple = (512, 1024, 2048, 4096, 8192, 16384, 32768,
                               65536, 131072)
    threads: int = 1                # host threads for traceback/SAM

    # --- output ---
    rg_id: str | None = None
    emit_md: bool = False           # MD:Z tags (host-side cost per record)
    report_secondary: bool = False

    def replace(self, **kw) -> "AlignConfig":
        return dataclasses.replace(self, **kw)


def preset(name: str) -> AlignConfig:
    """Read-type presets, mirroring the reference's pacbio/ont presets
    that re-tune scoring and seeding (SURVEY.md section 1)."""
    base = AlignConfig()
    if name in ("pacbio", "pb", "clr"):
        # High indel rate: cheaper gaps, denser seeds (at ~10% error a
        # clean 13-mer lands every ~4 windows; step 10 keeps short SV
        # parts above the chain score threshold).
        return base.replace(
            scores=ScoreParams(match=1, mismatch=3, gap_open=2, gap_ext=1),
            kmer=13, seed_step=10)
    if name in ("ont", "ont2d", "nanopore"):
        # ONT (non-CCS) error is substitution-heavier and runs past the
        # CLR envelope; denser seed sampling is the measured lever
        # (tools/ont_preset_sweep.py, sub-heavy profiles, CPU engine):
        # at 28% total error part_recall is 0.945 at step 6 vs 0.836 at
        # step 10; 1.000 vs 0.984 at 20%. Softening mismatch to 2
        # changed nothing, so scoring stays shared with pacbio
        # (BASELINE.md round-4 ont-preset table).
        return base.replace(
            scores=ScoreParams(match=1, mismatch=3, gap_open=2, gap_ext=1),
            kmer=13, seed_step=6)
    if name in ("default", "hifi", "ccs"):
        return base
    raise ValueError(f"unknown preset: {name!r}")
