"""FM-index operations in plain torch: batched backward search, 1-edit
variant tracks, and SA resolve.

Counterpart of ``lamsa_tpu/ops/fm.py`` (XLA gathers and fixed-trip
loops there, no Pallas kernel), which imports jax when it loads, so it
is copied here. Layout of the device tensors (``fm_device_state``), the
same bytes as the JAX package's uint32 arrays:

  blk     int32[ncp, 8]   per 64-base BWT block: 4 Occ checkpoint words
                          + the 4 packed BWT words (2 bits per base)
  mblk    int32[ncp2, 4]  per 64-row mark block: rank checkpoint + the
                          2 mark bitvector words + a pad word
  ssa_pos int32[nm]       SA values of the value-sampled rows
  C       int64[5]        C[c] = 1 + occurrences of chars < c
  primary, n_rows         int64 scalars: the sentinel's row, n + 1

blk, mblk and ssa_pos hold uint32 bit patterns; every gather widens to
int64 and masks with 0xFFFFFFFF at once. Rows, intervals, ranks and
positions are int64 (rows reach 3.1e9 at GRCh38 scale, past int32).
torch has no popcount, so ``popcount32`` is a SWAR count.
"""

from __future__ import annotations

import numpy as np
import torch

from lamsa_tpu_torch.ops.wire import U32
from lamsa_tpu_torch.utils.transfer import to_device


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit value held in an int64 tensor (SWAR; the
    byte-sum multiply stays below 2^57)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _u32(rec: torch.Tensor) -> torch.Tensor:
    """Widen gathered int32 bit patterns to their uint32 values."""
    return rec.to(torch.int64) & U32


def _rank_rec(rec, c, rem):
    """# of char c within a block record (…, 8) given rem = bases into
    the block: Occ checkpoint lane c + masked popcount of the 4 packed
    BWT words."""
    total = torch.gather(rec[..., :4], -1, c[..., None]).squeeze(-1)
    pat = 0x55555555 * c
    for o in range(4):
        y = ~(rec[..., 4 + o] ^ pat) & U32
        m = y & (y >> 1) & 0x55555555
        cov = (rem - 16 * o).clamp(0, 16)
        mask = torch.where(cov >= 16, U32, (1 << (2 * cov)) - 1)
        total = total + popcount32(m & mask)
    return total


def _rank(c, i, fm):
    """# of char c in full-BWT rows [0, i) (sentinel excluded); one
    record gather."""
    ip = i - (i > fm["primary"]).to(torch.int64)
    rec = _u32(fm["blk"][ip >> 6])
    return _rank_rec(rec, c, ip & 63)


def _mark_bit_and_rank(r, mblk):
    """(marked?, # marked rows before r) from one mark-block record."""
    rec = _u32(mblk[r >> 6])
    rem = r & 63
    total = rec[..., 0]
    for o in range(2):                                # 2 words of 32 rows
        cov = (rem - 32 * o).clamp(0, 32)
        mask = torch.where(cov >= 32, U32, (1 << cov) - 1)
        total = total + popcount32(rec[..., 1 + o] & mask)
    wsel = torch.where((r & 32) != 0, rec[..., 2], rec[..., 1])
    return ((wsel >> (r & 31)) & 1).bool(), total


def backward_search(win, win_ok, fm, k: int):
    """Exact backward search of (…, k) nt4 windows; returns (lo, hi)
    int64 row intervals, (0, 0) where invalid or absent."""
    shape = win.shape[:-1]
    lo = torch.zeros(shape, dtype=torch.int64, device=win.device)
    hi = fm["n_rows"].expand(shape)
    ok = win_ok
    for t in range(k):
        c = win[..., k - 1 - t].to(torch.int64).clamp(0, 3)
        base = fm["C"][c]
        lo = base + _rank(c, lo, fm)
        hi = base + _rank(c, hi, fm)
        ok = ok & (lo < hi)
    return torch.where(ok, lo, 0), torch.where(ok, hi, 0)


def edit1_tracks(k: int, kinds: str = "s"):
    """Static track tables for backward_search_1edit: patterns at edit
    distance exactly 1 from a k-length piece. 's': 3k substitution
    tracks (length k, win[p] ^ x for x in 1..3); 'd': k deletion tracks
    (length k - 1, read char j dropped); 'i': 4(k-1) insertion tracks
    (length k + 1, an extra ref char c in interior gap j). Returns int32
    arrays (typ, pos, aux, length) of shape (T,)."""
    typ, pos, aux, ln = [], [], [], []
    if "s" in kinds:
        for p in range(k):
            for x in (1, 2, 3):
                typ.append(0), pos.append(p), aux.append(x), ln.append(k)
    if "d" in kinds:
        for j in range(k):
            typ.append(1), pos.append(j), aux.append(0), ln.append(k - 1)
    if "i" in kinds:
        for j in range(1, k):
            for c in range(4):
                typ.append(2), pos.append(j), aux.append(c)
                ln.append(k + 1)
    return (np.asarray(typ, np.int32), np.asarray(pos, np.int32),
            np.asarray(aux, np.int32), np.asarray(ln, np.int32))


def backward_search_1edit(win, win_ok, fm, k: int, kinds: str = "s"):
    """Search every (…, k) window as T exact tracks, one per pattern at
    edit distance 1 (edit1_tracks); tracks shorter than k + 1 stop when
    exhausted. Returns (lo, hi) int64 of shape (…, T), (0, 0) where
    invalid or absent."""
    dev = win.device
    typ, pos, aux, ln = (
        to_device(torch.from_numpy(a.astype(np.int64)), dev)
        for a in edit1_tracks(k, kinds))
    T = typ.shape[0]
    shape = win.shape[:-1] + (T,)
    win = win.to(torch.int64)
    sub_c = (win[..., pos].clamp(0, 3) ^ aux) & 3                # (…, T)
    lo = torch.zeros(shape, dtype=torch.int64, device=dev)
    hi = fm["n_rows"].expand(shape)
    ok = win_ok[..., None].expand(shape)
    for t in range(k + 1):
        p = ln - 1 - t                                           # (T,)
        active = p >= 0
        # pattern[p] -> read-window index (a deletion skips win[pos], an
        # insertion shifts back past the inserted gap)
        idx = p + ((typ == 1) & (p >= pos)).to(torch.int64) \
            - ((typ == 2) & (p > pos)).to(torch.int64)
        c = win[..., idx.clamp(0, k - 1)]
        c = torch.where((typ == 0) & (p == pos), sub_c, c)
        c = torch.where((typ == 2) & (p == pos), aux, c).clamp(0, 3)
        base = fm["C"][c]
        lo_n = base + _rank(c, lo, fm)
        hi_n = base + _rank(c, hi, fm)
        lo = torch.where(active, lo_n, lo)
        hi = torch.where(active, hi_n, hi)
        ok = ok & (~active | (lo_n < hi_n))
    return torch.where(ok, lo, 0), torch.where(ok, hi, 0)


def resolve_rows(rows, valid, fm, sa_rate: int):
    """Rows -> text positions by a fixed-trip LF walk (<= sa_rate steps
    to a value-sampled row). int64 positions, 0 where invalid."""
    primary = fm["primary"]
    r = torch.where(valid, rows, 0)
    pos = torch.zeros_like(r)
    done = ~valid
    last_mark = fm["ssa_pos"].shape[0] - 1
    for steps in range(sa_rate + 1):
        at_p = r == primary
        mk, mrank = _mark_bit_and_rank(r, fm["mblk"])
        newly = ~done & (at_p | mk)
        pos = torch.where(newly & at_p, steps, pos)
        # an unmarked row past the last mark ranks one beyond ssa_pos
        # (the JAX gather clamps); only marked rows use the value
        samp = (_u32(fm["ssa_pos"][mrank.clamp(max=last_mark)]) + steps) \
            & U32
        pos = torch.where(newly & ~at_p, samp, pos)
        done = done | newly
        # LF step: one block-record gather serves bwt_char and rank
        rp = r - (r > primary).to(torch.int64)
        rec = _u32(fm["blk"][rp >> 6])
        w = torch.gather(rec[..., 4:8], -1, ((rp >> 4) & 3)[..., None]) \
            .squeeze(-1)
        c = (w >> (2 * (rp & 15))) & 3
        r_next = fm["C"][c] + _rank_rec(rec, c, rp & 63)
        r = torch.where(done, r, r_next)
    n_rows = fm["n_rows"]
    return torch.where(pos >= n_rows, pos - n_rows, pos)


def _i32(a: np.ndarray) -> torch.Tensor:
    """int32 tensor with the bytes of a uint32 array."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def fm_device_state(fm_host, device) -> dict:
    """FmIndex (host numpy) -> the tensors above on ``device``: the
    interleaved block records of ``lamsa_tpu.ops.fm.device_arrays``,
    byte for byte."""
    dev = torch.device(device)
    occ = fm_host.occ.astype(np.uint32)               # (ncp, 4)
    ncp = occ.shape[0]
    bwt = np.zeros(ncp * 4, np.uint32)
    bwt[:len(fm_host.bwt2)] = fm_host.bwt2
    blk = np.concatenate([occ, bwt.reshape(ncp, 4)], axis=1)

    rankcp = fm_host.ssa_rankcp.astype(np.uint32)     # (ncp2,)
    ncp2 = rankcp.shape[0]
    marks = np.zeros(ncp2 * 2, np.uint32)
    marks[:len(fm_host.ssa_marks)] = fm_host.ssa_marks
    mblk = np.concatenate(
        [rankcp[:, None], marks.reshape(ncp2, 2),
         np.zeros((ncp2, 1), np.uint32)], axis=1)     # 4-lane records

    i64 = dict(dtype=torch.int64)
    return {
        "C": to_device(torch.tensor(fm_host.C.tolist(), **i64), dev),
        "primary": to_device(torch.tensor(int(fm_host.primary), **i64),
                             dev),
        "n_rows": to_device(torch.tensor(int(fm_host.n) + 1, **i64), dev),
        "blk": to_device(_i32(blk), dev),
        "mblk": to_device(_i32(mblk), dev),
        "ssa_pos": to_device(_i32(fm_host.ssa_pos), dev),
    }
