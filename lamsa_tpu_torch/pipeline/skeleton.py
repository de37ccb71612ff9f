# Copy of lamsa_tpu/pipeline/skeleton.py; only its import lines differ.
"""Split-alignment skeleton assembly (host side).

Consumes the device chain kernel's output (ops/chain.py) and produces
per-read "skeletons": ordered lists of alignment parts, each part a run
of co-linear anchors on one strand, with SV events classified between
adjacent parts (SURVEY.md section 1 stage 2: strand flip -> inversion;
reference jump -> deletion / duplication / translocation; query jump ->
insertion). This is branchy bookkeeping over tiny arrays — host Python
by design (SURVEY.md section 7 step 4); the FLOPs all live in the
device kernels on either side.

Coordinate conventions: anchors of a '-'-strand part are in
reverse-complemented-read coordinates (pipeline/seeding.py); read-space
spans are derived when ordering parts. rpos are global concatenated
reference coordinates (int64 on host).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Part:
    """One alignment part: co-linear anchor run on one strand."""
    strand: int                  # 0 = '+', 1 = '-'
    anchors: np.ndarray          # int64[n, 2] (qpos strand-coords, rpos)
    score: int                   # chain DP score
    read_start: int              # read-space span covered by anchors
    read_end: int
    mapq: int = 0

    @property
    def n_anchors(self) -> int:
        return len(self.anchors)


@dataclasses.dataclass
class Skeleton:
    parts: list                  # [Part] in read order
    events: list                 # [dict] SV events between adjacent parts
    alt_score: int               # best rejected-chain score (for MAPQ)
    secondaries: list = dataclasses.field(default_factory=list)  # [Part]


def _anchor_read_interval(q, k, strand, read_len):
    """Read-space interval covered by one anchor (strand coords -> read)."""
    if strand == 0:
        return int(q), int(q) + k
    return read_len - int(q) - k, read_len - int(q)


def _anchor_coverage(qs, k, strand, read_len):
    """bool[read_len + 1] coverage of the anchors' read intervals
    (vectorized equivalent of OR-ing _anchor_read_interval slices)."""
    if strand == 0:
        a = qs
        b = qs + k
    else:
        a = read_len - qs - k
        b = read_len - qs
    a = np.clip(a, 0, read_len + 1)
    b = np.clip(b, a, read_len + 1)
    d = np.zeros(read_len + 2, np.int32)
    np.add.at(d, a, 1)
    np.add.at(d, b, -1)
    return np.cumsum(d[:read_len + 1]) > 0


def backtrack_chains(f, pred, qpos, rpos, strand, valid, *, k, read_len,
                     min_anchors=2, min_score=0, max_chains=8,
                     max_overlap_frac=0.5, keep_secondaries=0):
    """Select chains from sparse-DP output.

    Greedy by descending end-score: walk predecessors, skip chains that
    share hits with accepted chains or whose ANCHOR-covered read
    positions overlap accepted chains' anchor coverage by more than
    max_overlap_frac of the chain's own anchor coverage. Coverage (not
    span) is the right overlap notion on both sides: a chain that jumps
    across an inversion covers the flanks but not the inverted middle,
    which must stay claimable by the opposite-strand chain (SURVEY.md
    section 1 stage 2); and a chain from a diverged repeat copy covers
    roughly the SAME windows as the accepted true chain, so normalizing
    by its own (sparse) coverage — not its read span — rejects it into
    alt_score instead of emitting a wrong supplementary record (the
    MAPQ calibration failure mode). Returns (parts: [Part] in read
    order, alt_score: best rejected score).
    """
    from lamsa_tpu_torch import native
    sel = native.backtrack_chains_native(
        f, pred, qpos, strand, valid, k=k, read_len=read_len,
        min_anchors=min_anchors, min_score=min_score,
        max_chains=max_chains, max_overlap_frac=max_overlap_frac,
        keep_secondaries=keep_secondaries)
    if sel is None:
        sel = _select_chains_py(f, pred, qpos, strand, valid, k=k,
                                read_len=read_len, min_anchors=min_anchors,
                                min_score=min_score, max_chains=max_chains,
                                max_overlap_frac=max_overlap_frac,
                                keep_secondaries=keep_secondaries)
    chains, alt_score = sel
    parts: list[Part] = []
    secondaries: list[Part] = []
    for idxs, is_sec, score, st, rs, re_ in chains:
        anchors = np.stack([np.asarray(qpos)[idxs].astype(np.int64),
                            np.asarray(rpos)[idxs].astype(np.int64)],
                           axis=1)
        part = Part(strand=st, anchors=anchors, score=score,
                    read_start=rs, read_end=re_)
        (secondaries if is_sec else parts).append(part)

    parts = split_parts_on_foreign_gaps(parts, k=k, read_len=read_len,
                                        min_anchors=min_anchors)
    parts.sort(key=lambda p: (p.read_start, p.read_end))
    return parts, alt_score, secondaries


def _select_chains_py(f, pred, qpos, strand, valid, *, k, read_len,
                      min_anchors, min_score, max_chains,
                      max_overlap_frac, keep_secondaries):
    """Python spec of the greedy chain selection (the native C++ twin
    lamsa_backtrack_chains must match it exactly; property-tested in
    tests/test_skeleton.py). Returns (chains, alt_score) with chains =
    [(hit_idxs, is_secondary, score, strand, read_start, read_end)] in
    encounter order."""
    H = len(f)
    order = np.argsort(-f, kind="stable")
    used = np.zeros(H, bool)
    covered = np.zeros(read_len + 1, bool)
    chains = []
    n_parts = 0
    n_sec = 0
    alt_score = 0

    for end in order:
        if f[end] < min_score or not valid[end]:
            break
        if used[end]:
            continue
        # walk the chain
        idxs = []
        i = int(end)
        clean = True
        while i >= 0:
            if used[i]:
                clean = False  # merges into an already-taken chain
                break
            idxs.append(i)
            i = int(pred[i])
        if not clean or len(idxs) < min_anchors:
            for i in idxs:
                used[i] = True
            continue
        idxs.reverse()
        used[np.array(idxs)] = True

        st = int(strand[idxs[0]])
        q0, q1 = int(qpos[idxs[0]]), int(qpos[idxs[-1]]) + k
        if st == 0:
            rs, re_ = q0, q1
        else:  # rc coords -> read coords
            rs, re_ = read_len - q1, read_len - q0
        own_cov = _anchor_coverage(np.asarray(qpos)[idxs], k, st, read_len)
        overlap = int((own_cov & covered).sum())
        is_sec = False
        if overlap > max_overlap_frac * max(int(own_cov.sum()), 1) \
                or n_parts >= max_chains:
            alt_score = max(alt_score, int(f[end]))
            if n_sec >= keep_secondaries:
                continue
            is_sec = True
            n_sec += 1
        else:
            covered |= own_cov
            n_parts += 1
        chains.append((np.asarray(idxs, np.int32), is_sec, int(f[end]),
                       st, rs, re_))
    return chains, alt_score


def split_parts_on_foreign_gaps(parts, *, k, read_len, min_anchors=2,
                                min_foreign=None):
    """Split a part at inner anchor gaps whose read interval is covered
    by ANOTHER part's anchors.

    This is how a chain that runs co-linearly across an inversion (or any
    same-diagonal SV with a foreign middle) gets cut into its true flank
    parts: the opposite-strand middle chain claims the interior, so the
    spanning chain must not gap-fill across it (SURVEY.md section 1
    stage 2 — the inversion signature is + / - / + parts).
    """
    if len(parts) <= 1:
        return parts
    if min_foreign is None:
        min_foreign = max(k, 30)
    cov = [_anchor_coverage(p.anchors[:, 0], k, p.strand, read_len)
           for p in parts]
    total = np.zeros(read_len + 1, np.int32)
    for c in cov:
        total += c

    out = []
    for pi, p in enumerate(parts):
        foreign = (total - cov[pi].astype(np.int32)) > 0
        # prefix sums: foreign[lo:hi].sum() == pref[hi] - pref[lo]
        pref = np.zeros(read_len + 2, np.int64)
        np.cumsum(foreign, out=pref[1:])
        qa = p.anchors[:-1, 0]
        qb = p.anchors[1:, 0]
        if p.strand == 0:
            lo_i, hi_i = qa + k, qb
        else:
            lo_i, hi_i = read_len - qb, read_len - qa - k
        lo_c = np.clip(lo_i, 0, read_len + 1)
        hi_c = np.clip(hi_i, lo_c, read_len + 1)
        cut = (hi_i > lo_i) & (pref[hi_c] - pref[lo_c] >= min_foreign)
        if not cut.any():
            out.append(p)
            continue
        # runs[j] = anchor indices between consecutive cut gaps
        bounds = np.flatnonzero(cut) + 1
        runs = [list(range(a, b)) for a, b in
                zip(np.concatenate([[0], bounds]),
                    np.concatenate([bounds, [p.n_anchors]]))]
        n_tot = max(p.n_anchors, 1)
        for run in runs:
            if len(run) < min_anchors:
                continue
            anchors = p.anchors[run]
            q0, q1 = int(anchors[0, 0]), int(anchors[-1, 0]) + k
            if p.strand == 0:
                rs, re_ = q0, q1
            else:
                rs, re_ = read_len - q1, read_len - q0
            out.append(Part(strand=p.strand, anchors=anchors,
                            score=max(1, p.score * len(run) // n_tot),
                            read_start=rs, read_end=re_))
    return out


def classify_events(parts, ref, *, sv_min_size=30, sv_max_size=100000):
    """SV events between adjacent parts (SURVEY.md section 1 stage 2).

    Events are annotations — the split itself is the primary output; the
    classification feeds observability and the optional sv:Z: SAM tag.
    """
    events = []
    for a, b in zip(parts, parts[1:]):
        if a.strand != b.strand:
            events.append({"type": "inversion",
                           "read_pos": a.read_end})
            continue
        # forward-genome coordinates of the junction
        if a.strand == 0:
            r_end_a = int(a.anchors[-1, 1])
            r_start_b = int(b.anchors[0, 1])
        else:  # rc parts traverse the genome backwards in read order
            r_end_a = int(a.anchors[0, 1])
            r_start_b = int(b.anchors[-1, 1])
        dq = b.read_start - a.read_end
        dr = (r_start_b - r_end_a) if a.strand == 0 else (r_end_a - r_start_b)
        same_chrom = not ref.crosses_boundary(
            min(r_end_a, r_start_b), abs(dr) + 1) if ref is not None else True
        if not same_chrom or abs(dr) > sv_max_size:
            events.append({"type": "translocation", "read_pos": a.read_end})
        elif dr < -sv_min_size:
            events.append({"type": "duplication", "read_pos": a.read_end,
                           "size": -dr})
        elif dr - dq > sv_min_size:
            events.append({"type": "deletion", "read_pos": a.read_end,
                           "size": dr - dq})
        elif dq - dr > sv_min_size:
            events.append({"type": "insertion", "read_pos": a.read_end,
                           "size": dq - dr})
        else:
            events.append({"type": "gap", "read_pos": a.read_end})
    return events


def build_skeleton(f, pred, qpos, rpos, strand, valid, *, k, read_len, ref,
                   config) -> Skeleton:
    parts, alt, secondaries = backtrack_chains(
        f, pred, qpos, rpos, strand, valid, k=k, read_len=read_len,
        min_anchors=2, min_score=config.chain_min_score * k,
        max_chains=config.max_chains_per_read,
        keep_secondaries=3 if config.report_secondary else 0)
    events = classify_events(parts, ref, sv_min_size=config.sv_min_size,
                             sv_max_size=config.sv_max_size)
    return Skeleton(parts=parts, events=events, alt_score=alt,
                    secondaries=secondaries)


def anchors_to_blocks(anchors: np.ndarray, k: int):
    """Chain anchors -> non-overlapping exact-match blocks.

    Overlapping same-diagonal anchors merge into longer blocks;
    overlapping off-diagonal anchors are dropped (conflicts). Returns
    int64[m, 3] rows (q_start, r_start, length) with strictly
    non-overlapping, monotone blocks. Hot per-part loop: delegates to
    the native C++ twin when available (this body is the spec,
    property-tested equal in tests/test_skeleton.py).
    """
    from lamsa_tpu_torch import native
    nb = native.anchors_to_blocks(anchors, k)
    if nb is not None:
        return nb
    return anchors_to_blocks_py(anchors, k)


def anchors_to_blocks_py(anchors: np.ndarray, k: int):
    """Python spec for anchors_to_blocks (fallback + differential
    tests)."""
    blocks: list[list[int]] = []
    for q, r in anchors:
        q, r = int(q), int(r)
        if not blocks:
            blocks.append([q, r, k])
            continue
        bq, br, bl = blocks[-1]
        if q - r == bq - br and q <= bq + bl:       # same diag, contiguous
            blocks[-1][2] = max(bl, q + k - bq)
        elif q >= bq + bl and r >= br + bl:          # clean new block
            blocks.append([q, r, k])
        # else: conflicting overlap -> drop anchor
    return np.asarray(blocks, dtype=np.int64).reshape(-1, 3)
