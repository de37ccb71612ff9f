"""Seeding in plain torch: windows, keys, index lookup, hit packing.

Counterpart of ``lamsa_tpu/pipeline/seeding.py``, both backends. Same
output contract: per read, hits sorted by (strand, qpos, rpos) and cut
to ``max_hits``; qpos/strand int64, rpos int64 holding the uint32 bit
pattern, valid bool. Keys, rows and reference positions are int64 on
the device; uint32 arithmetic is reproduced with explicit masks.

k-mer backend: ``table_lookup`` binary-searches the sorted key table
(``torch.searchsorted``) on every device; its hits equal those of the
JAX package's sorted and direct-address lookups. FM backend
(``seed_hits_fm``): backward search, per-seed candidate rows, the
seg-quota drop and truncation on SA-row order, then SA resolve of the
survivors only (``ops/fm.py``). Its parts are spans of their own,
``fm_search``, ``fm_1edit`` and ``fm_resolve``, opened inside the
caller's ``seed_hits`` stage.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from lamsa_tpu_torch.ops import fm as fmops
from lamsa_tpu_torch.ops.wire import U32
from lamsa_tpu_torch.utils.timers import GLOBAL as STATS

_QPOS_BITS = 19                       # reads up to 512 kb
INVALID_K1 = 1 << 24                  # > any strand << QPOS_BITS | qpos

# number of read segments for the whole-genome hit quota (seed_hits_fm
# seg_quota): hits are budgeted per (strand, read segment) so random
# genome-scale noise cannot crowd out the read tail or the '-' strand
# before truncation to max_hits
N_SEG = 16


def extract_windows(read_codes, read_len, qpos_grid, k):
    """Window gather: (B, S, k) nt4 windows + (B, S) validity. Indices
    past the read matrix clamp to its last column, as JAX gathers do
    (only windows longer than the grid's k reach there, and those are
    invalid)."""
    win_idx = (qpos_grid[:, None]
               + torch.arange(k, device=qpos_grid.device)).clamp(
                   max=read_codes.shape[1] - 1)
    win = read_codes[:, win_idx]                                  # (B, S, k)
    win_ok = (win < 4).all(dim=2) & (
        (qpos_grid[None, :] + k) <= read_len[:, None])
    return win, win_ok


def window_keys(win, k):
    """Packed 2-bit k-mer keys for both strands of (B, S, k) windows."""
    w = win.to(torch.int64) & 3
    ar = torch.arange(k, dtype=torch.int64, device=win.device)
    key_f = (w << (2 * (k - 1 - ar))).sum(dim=2) & U32
    key_r = ((w ^ 3) << (2 * ar)).sum(dim=2) & U32
    return key_f, key_r


def seed_rotation(qpos_grid):
    """Per-window quasi-random rotation (uint32 hash of the grid
    position, masked before the shift)."""
    return ((qpos_grid.to(torch.int64) * 2654435761) & U32) >> 8


def candidate_rotation(rot, count, C):
    """Offset into a key's occurrence list for a seed keeping C of
    `count` candidates; 0 whenever count <= C."""
    count = count.to(torch.int64)
    maxoff = torch.clamp(count - C + 1, min=1)
    return torch.where(count > C, rot % maxoff, 0)


def table_lookup(keys, idx_keys, idx_starts, idx_counts, idx_positions, C,
                 rot):
    """Sorted-table candidate lookup: (B, S) keys -> (B, S, C) positions
    + ok. Absent keys yield ok=False lanes."""
    i = torch.searchsorted(idx_keys, keys)
    i_c = torch.clamp(i, max=idx_keys.shape[0] - 1)
    found = (i < idx_keys.shape[0]) & (idx_keys[i_c] == keys)
    start = idx_starts[i_c].to(torch.int64)
    count = idx_counts[i_c].to(torch.int64)
    o0 = candidate_rotation(rot[None, :], count, C)
    offs = torch.arange(C, device=keys.device)[None, None, :]
    pidx = torch.clamp(start[..., None] + o0[..., None] + offs,
                       max=idx_positions.shape[0] - 1)
    pos = idx_positions[pidx]
    ok = found[..., None] & (o0[..., None] + offs < count[..., None])
    return pos, ok


def pack_hits(qpos_grid, read_len, pos_f, ok_f, pos_r, ok_r, win_ok, *,
              k, max_hits):
    """Candidate (pos, ok) pairs for both strands -> the sorted,
    truncated per-read hit arrays. The sort is single-key
    (strand << 19 | qpos) and stable: each key value is one window's
    candidate slots, which arrive rpos-ascending."""
    B = read_len.shape[0]
    S, C = pos_f.shape[1], pos_f.shape[2]
    qp_f = qpos_grid.to(torch.int64)[None, :, None].expand(B, S, C)
    qp_r = read_len.to(torch.int64)[:, None, None] - qp_f - k   # rc coords
    ok_f = ok_f & win_ok[:, :, None]
    ok_r = ok_r & win_ok[:, :, None]

    def k1(qp, strand, ok):
        return torch.where(ok, (strand << _QPOS_BITS) | qp, INVALID_K1)

    key1 = torch.cat([k1(qp_f, 0, ok_f).reshape(B, S * C),
                      k1(qp_r, 1, ok_r).reshape(B, S * C)], dim=1)
    key2 = torch.cat([pos_f.reshape(B, S * C), pos_r.reshape(B, S * C)],
                     dim=1)
    key1, key2 = _stable_sort(key1, key2)
    key1 = key1[:, :max_hits]
    key2 = key2[:, :max_hits]

    valid = key1 < INVALID_K1
    qpos = torch.where(valid, key1 & ((1 << _QPOS_BITS) - 1), 0)
    strand = torch.where(valid, key1 >> _QPOS_BITS, 0)
    rpos = torch.where(valid, key2, 0)
    return {"qpos": qpos, "rpos": rpos, "strand": strand, "valid": valid}


def seed_hits(read_codes, read_len, qpos_grid, idx_keys, idx_starts,
              idx_counts, idx_positions, *, k, cands_per_seed, max_hits):
    """Seed hits for a batch of reads from the sorted k-mer table.
    read_codes int[B, L] padded with 4; read_len int[B]; qpos_grid
    int[S]; idx_keys / idx_positions int64 (uint32 values)."""
    win, win_ok = extract_windows(read_codes, read_len, qpos_grid, k)
    key_f, key_r = window_keys(win, k)
    rot = seed_rotation(qpos_grid)
    tab = (idx_keys, idx_starts, idx_counts, idx_positions, cands_per_seed)
    pos_f, ok_f = table_lookup(key_f, *tab, rot)
    pos_r, ok_r = table_lookup(key_r, *tab, rot)
    return pack_hits(qpos_grid, read_len, pos_f, ok_f, pos_r, ok_r, win_ok,
                     k=k, max_hits=max_hits)


def _stable_sort(key1, rows):
    """Sort key1 per read, stably, carrying rows along."""
    key1, order = torch.sort(key1, dim=1, stable=True)
    return key1, rows.gather(1, order)


def _seg_quota_drop(key1, L, seg_quota):
    """Cap hits per (strand, read segment): keep a strided sample of
    each group's sorted candidates (offsets 0, stride, 2 stride, ...;
    stride = ceil(group size / seg_quota)) and invalidate the rest."""
    B, total = key1.shape
    dev = key1.device
    qp = key1 & ((1 << _QPOS_BITS) - 1)
    seg = torch.clamp(qp * N_SEG // L, max=N_SEG - 1)
    gid = torch.where(key1 < INVALID_K1,
                      (key1 >> _QPOS_BITS) * N_SEG + seg, -1)
    idx = torch.arange(total, device=dev).expand(B, total)
    newg = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                      gid[:, 1:] != gid[:, :-1]], dim=1)
    gstart = torch.cummax(torch.where(newg, idx, -1), dim=1).values
    # exclusive suffix-min of group starts = this group's end
    nxt = torch.where(newg, idx, total)
    nxt = torch.cat([nxt[:, 1:], torch.full((B, 1), total, dtype=idx.dtype,
                                            device=dev)], dim=1)
    gend = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    stride = (gend - gstart + seg_quota - 1) // seg_quota
    drop = (gid >= 0) & ((idx - gstart) % stride.clamp(min=1) != 0)
    return torch.where(drop, INVALID_K1, key1)


@contextlib.contextmanager
def _fm_part(name, events, dev):
    """A span of one part of FM seeding; with ``events`` (a list, on a
    CUDA device) also a pair of timing events on dev's current stream
    around the part's launches, appended as (name, start, end) for the
    caller to read once it has synchronized that stream."""
    with STATS.stage(name):
        if events is None:
            yield
            return
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        events.append((name, start, end))


def seed_hits_fm(read_codes, read_len, qpos_grid, fm, *, k, cands_per_seed,
                 max_hits, sa_rate, seg_quota=0, sub1_cands=0, sub1_k=0,
                 sub1_kinds="s", events=None):
    """Seed hits for a batch of reads from the FM index (fm: the
    ``ops.fm.fm_device_state`` tensors). Same contract as seed_hits.

    Both strands' windows are backward-searched; each seed keeps C
    candidate SA rows from its interval (rotated per seed for
    >C-occurrence intervals). With sub1_cands, every window's 1-edit
    variants (length sub1_k, default k) add sub1_cands rows per variant
    track. Hits are stably sorted on (strand | qpos), optionally thinned
    per (strand, read segment) to seg_quota, and cut to max_hits on
    SA-row order; only the survivors are resolved to text positions,
    then re-sorted on (strand | qpos, rpos). The truncation boundary
    group thus keeps the smallest SA rows, not the smallest positions,
    as in the JAX package. Invalid lanes resolve row 0 and come out as
    position 0.

    Spans ``fm_search`` (both strands' exact search), ``fm_1edit`` (the
    variant tracks) and ``fm_resolve`` (SA resolve); the counter
    ``fm_1edit_tracks`` counts the variant tracks searched (window x
    track x strand). ``events``: a list that collects each part's CUDA
    timing events (_fm_part); None off CUDA."""
    B, L = read_codes.shape
    S = qpos_grid.shape[0]
    C = cands_per_seed
    dev = read_codes.device

    win, win_ok = extract_windows(read_codes, read_len, qpos_grid, k)
    win_rc = (3 - win.flip(-1)) & 3                               # revcomp

    with _fm_part("fm_search", events, dev):
        lo_f, hi_f = fmops.backward_search(win, win_ok, fm, k)
        lo_r, hi_r = fmops.backward_search(win_rc, win_ok, fm, k)

    offs = torch.arange(C, device=dev)[None, None, :]
    rot = seed_rotation(qpos_grid)

    def cand_rows(lo, hi):
        o0 = candidate_rotation(rot[None, :], hi - lo, C)
        rows = ((lo + o0)[:, :, None] + offs) & U32
        return rows, rows < hi[:, :, None]

    rows_f, ok_f = cand_rows(lo_f, hi_f)
    rows_r, ok_r = cand_rows(lo_r, hi_r)
    ok_f = ok_f & win_ok[:, :, None]
    ok_r = ok_r & win_ok[:, :, None]

    qp_f = qpos_grid.to(torch.int64)[None, :, None].expand(B, S, C)
    qp_r = read_len.to(torch.int64)[:, None, None] - qp_f - k

    def k1(qp, strand, ok):
        return torch.where(ok, (strand << _QPOS_BITS) | qp, INVALID_K1)

    key1_parts = [k1(qp_f, 0, ok_f).reshape(B, S * C),
                  k1(qp_r, 1, ok_r).reshape(B, S * C)]
    rows_parts = [rows_f.reshape(B, S * C), rows_r.reshape(B, S * C)]

    if sub1_cands:
        C1 = sub1_cands
        ks1 = sub1_k or k
        if ks1 == k:
            win1, win1_ok = win, win_ok
        else:
            win1, win1_ok = extract_windows(read_codes, read_len,
                                            qpos_grid, ks1)
        win1_rc = (3 - win1.flip(-1)) & 3
        with _fm_part("fm_1edit", events, dev):
            lo1f, hi1f = fmops.backward_search_1edit(win1, win1_ok, fm, ks1,
                                                     kinds=sub1_kinds)
            lo1r, hi1r = fmops.backward_search_1edit(win1_rc, win1_ok, fm,
                                                     ks1, kinds=sub1_kinds)
        T = lo1f.shape[-1]
        STATS.count("fm_1edit_tracks", 2 * B * S * T)
        offs1 = torch.arange(C1, device=dev)[None, None, None, :]

        def cand1(lo, hi):
            r = (lo[..., None] + offs1) & U32              # (B, S, T, C1)
            return r, (r < hi[..., None]) & win1_ok[:, :, None, None]

        r1f, o1f = cand1(lo1f, hi1f)
        r1r, o1r = cand1(lo1r, hi1r)
        qp1f = qp_f[:, :, :1, None].expand(B, S, T, C1)
        # rc coords use the sub1 window length (a ks1-long window at
        # forward qp occupies rc-read position L - qp - ks1)
        qp1r = (read_len.to(torch.int64)[:, None]
                - qpos_grid.to(torch.int64)[None, :] - ks1)[
                    :, :, None, None].expand(B, S, T, C1)
        key1_parts += [k1(qp1f, 0, o1f).reshape(B, S * T * C1),
                       k1(qp1r, 1, o1r).reshape(B, S * T * C1)]
        rows_parts += [r1f.reshape(B, S * T * C1),
                       r1r.reshape(B, S * T * C1)]

    key1, rows = _stable_sort(torch.cat(key1_parts, dim=1),
                              torch.cat(rows_parts, dim=1))
    if seg_quota:
        key1, rows = _stable_sort(_seg_quota_drop(key1, L, seg_quota), rows)
    key1 = key1[:, :max_hits]
    rows = rows[:, :max_hits]

    valid = key1 < INVALID_K1
    with _fm_part("fm_resolve", events, dev):
        rpos = fmops.resolve_rows(rows, valid, fm, sa_rate)
    # (key1, rpos) two-key sort as one int64 key: key1 < 2^25, rpos < 2^32
    key = torch.sort((key1 << 32) | rpos, dim=1).values
    key1, rpos = key >> 32, key & U32

    qpos = torch.where(valid, key1 & ((1 << _QPOS_BITS) - 1), 0)
    strand = torch.where(valid, key1 >> _QPOS_BITS, 0)
    rpos = torch.where(valid, rpos, 0)
    return {"qpos": qpos, "rpos": rpos, "strand": strand, "valid": valid}


def make_qpos_grid(bucket_len: int, k: int, step: int) -> np.ndarray:
    """Static sample grid for a read-length bucket."""
    n = max(1, (bucket_len - k) // step + 1)
    return np.arange(n, dtype=np.int32) * step
