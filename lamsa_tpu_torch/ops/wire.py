"""Device-side data movement around the DP kernels, in plain torch.

Counterparts of the non-kernel parts of ``lamsa_tpu/ops/banded_sw.py``:
4-bit packed code words and their gathers, the (B, 4) descriptor wire,
the global band offset, score extraction, and the compact traceback
wire with its host decode. The JAX package computes all of these
outside any Pallas kernel, so plain torch is their port.

Integers: reference positions and other uint32 bit patterns are carried
as int64 on the device; every place where the JAX code relies on uint32
wraparound masks with ``& 0xFFFFFFFF`` explicitly, and int32 wire words
are produced from their bit patterns with ``to_i32``.
"""

from __future__ import annotations

import numpy as np
import torch

from lamsa_tpu_torch.utils.transfer import to_host

U32 = 0xFFFFFFFF

# The DP contract's sentinel and zdrop cadence (lamsa_tpu/ops/oracle.py
# NEG_INF, ZDROP_GROUP): dead cells hold NEG_INF, and zdrop is tested
# after every ZDROP_GROUP-th row.
NEG_INF = -(1 << 29)
ZDROP_GROUP = 32

# Packed-descriptor wire format (one (B, 4) int32 array per chunk),
# identical to lamsa_tpu/ops/banded_sw.py:
#   word 0: q_base (int32 flat-read offset)
#   word 1: t_base (uint32 bit-pattern, genomes to 4 Gb)
#   word 2: m_len | n_len << 16          (both <= M + W < 2^16)
#   word 3: (lo + _LO_BIAS) [13 bits] | q_step<0 << 13 | t_step<0 << 14
#           | q_comp << 15 | is_global << 16 | bonus << 17
_LO_BIAS = 4096


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor with the low 32 bits of integer tensor x (the int32
    view of a uint32 bit pattern)."""
    x = x.to(torch.int64) & U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def longest_first(steps: torch.Tensor) -> torch.Tensor:
    """int32 instance order by descending step count (stable: equal
    counts keep their index order), computed where ``steps`` lies. The
    DP kernels' persistent warps take instances in this order, so the
    longest start first."""
    return torch.argsort(steps, descending=True, stable=True) \
        .to(torch.int32)


def first_argmax(x: torch.Tensor, dim: int = 1):
    """(max, index of the FIRST maximum) along dim — the jnp.argmax tie
    rule, computed explicitly."""
    mx = x.amax(dim=dim, keepdim=True)
    idx = torch.arange(x.shape[dim], device=x.device)
    shape = [1] * x.dim()
    shape[dim] = -1
    first = torch.where(x == mx, idx.view(shape), x.shape[dim]) \
        .amin(dim=dim)
    return mx.squeeze(dim), first


# ------------------------------------------------------- packed code words

def pack_codes_words(codes) -> np.ndarray:
    """Host-side 4-bit pack of nt codes (0..4) into int32 words, padded
    with 4 (N): code i at word i >> 3, nibble i & 7."""
    codes = np.ascontiguousarray(codes, np.uint8)
    pad = (-len(codes)) % 8
    if pad:
        codes = np.concatenate([codes, np.full(pad, 4, np.uint8)])
    b = codes[0::2] | (codes[1::2] << 4)
    return b.view(np.int32)


def gather_packed_run(words, i0, step, X: int):
    """out[b, y] = code at flat index (i0[b] + step[b]*y) mod 2^32 for
    y in [0, X), from an int32 word tensor. i0 is a uint32 bit pattern
    (int64 tensor); step is +-1. Lanes whose index falls outside the
    array gather clamped garbage and must be masked by the caller."""
    y = torch.arange(X, dtype=torch.int64, device=words.device)[None, :]
    idx = (i0.to(torch.int64)[:, None] + step.to(torch.int64)[:, None] * y) \
        & U32
    w = words[torch.clamp(idx >> 3, max=words.shape[0] - 1)]
    return (w >> ((idx & 7) * 4).to(torch.int32)) & 0xF


def gather_windows(flat_reads, ref_codes, q_base, q_step, q_comp, t_base,
                   t_step, m_len, n_len, lo, *, M, W):
    """DP windows from descriptors (lamsa_tpu/ops/banded_sw.py
    gather_windows): q int32[B, M] (element y = flat[q_base + q_step*y],
    complemented when q_comp, 4 past m_len) and t_win int32[B, M+W]
    (position x = ref[t_base + t_step*(x + lo)] where 0 <= x + lo < n_len,
    sentinel 5 elsewhere)."""
    dev = flat_reads.device
    xq = torch.arange(M, device=dev)[None, :]
    qg = gather_packed_run(flat_reads, q_base & U32, q_step, M)
    qg = torch.where((q_comp[:, None] == 1) & (qg < 4), 3 - qg, qg)
    q = torch.where(xq < m_len[:, None], qg, 4)

    xt = torch.arange(M + W, device=dev)[None, :]
    y = xt + lo[:, None]
    tvalid = (y >= 0) & (y < n_len[:, None])
    # start index t_base + t_step*lo in uint32 (wraps when the band head
    # hangs off the reference start; those lanes are invalid)
    ti0 = (t_base.to(torch.int64) + t_step.to(torch.int64)
           * lo.to(torch.int64)) & U32
    tg = gather_packed_run(ref_codes, ti0, t_step, M + W)
    t_win = torch.where(tvalid, tg, 5)
    return q.to(torch.int32).contiguous(), t_win.to(torch.int32).contiguous()


# ------------------------------------------------------------ descriptors

def pack_desc(q_base, q_step, q_comp, t_base, t_step, m_len, n_len, lo,
              is_global, bonus):
    """Host-side descriptor packing (numpy; see wire format above)."""
    B = len(m_len)
    d = np.empty((B, 4), np.int32)
    d[:, 0] = q_base
    d[:, 1] = np.asarray(t_base, np.uint64).astype(np.uint32) \
        .view(np.int32)
    d[:, 2] = m_len | (np.asarray(n_len, np.int64) << 16)
    d[:, 3] = ((np.asarray(lo, np.int64) + _LO_BIAS)
               | ((np.asarray(q_step, np.int64) < 0) << 13)
               | ((np.asarray(t_step, np.int64) < 0) << 14)
               | (np.asarray(q_comp, np.int64) << 15)
               | (np.asarray(is_global, np.int64) << 16)
               | (np.asarray(bonus, np.int64) << 17))
    return d


def unpack_desc(desc):
    """Device-side unpack of pack_desc: int64 tensors (t_base as its
    uint32 bit pattern, is_global bool)."""
    d = desc.to(torch.int64)
    q_base = d[:, 0]
    t_base = d[:, 1] & U32
    m_len = d[:, 2] & 0xFFFF
    n_len = (d[:, 2] >> 16) & 0xFFFF
    w3 = d[:, 3]
    lo = (w3 & 0x1FFF) - _LO_BIAS
    q_step = 1 - 2 * ((w3 >> 13) & 1)
    t_step = 1 - 2 * ((w3 >> 14) & 1)
    q_comp = (w3 >> 15) & 1
    is_global = ((w3 >> 16) & 1).to(torch.bool)
    bonus = w3 >> 17
    return (q_base, q_step, q_comp, t_base, t_step, m_len, n_len, lo,
            is_global, bonus)


def global_lo(m, n, W):
    """Band low offset for global instances (even; shared by every
    engine). Scalars or numpy arrays."""
    need = np.abs(n - m) + 1
    lo = np.minimum(0, n - m) - (W - need) // 2
    return lo - (lo & 1)


def a_pad(M: int, W: int) -> int:
    """Antidiagonal step count of an (M, W) bucket: a = i + j <= m + n
    with m <= M and n <= M + W - 1, rounded up to a multiple of 128
    (lamsa_tpu/ops/banded_sw_adiag.py a_pad). The antidiagonal direction
    words are int32[B, a_pad / 4, W / 2]."""
    return -(-(2 * M + W) // 128) * 128


# ------------------------------------------------------- score extraction

def extract_scores(h_last, m_len, n_len, lo):
    """Global score H[m][n] per instance, and the best last-row (to-end)
    cell for extend clip decisions (first lane on ties). Returns
    (global_score, te_score, te_d), int64 [B]."""
    B, W = h_last.shape
    h = h_last.to(torch.int64)
    m, n, lo = m_len.to(torch.int64), n_len.to(torch.int64), \
        lo.to(torch.int64)
    d_g = torch.clamp(n - m - lo, 0, W - 1)
    g = h.gather(1, d_g[:, None])[:, 0]
    lanes = torch.arange(W, device=h.device)[None, :]
    j = m[:, None] + lo[:, None] + lanes
    valid = (j >= 0) & (j <= n[:, None])
    te, te_d = first_argmax(torch.where(valid, h, NEG_INF), dim=1)
    return g, te, te_d


# ---------------------------------------------------- compact traceback wire

def compact_E(M: int) -> int:
    """Event-slot budget of the compact traceback encoding for an M-row
    bucket (lamsa_tpu/ops/banded_sw.py compact_E)."""
    return M // 16 + 8


def compact_wide(M: int) -> bool:
    """Buckets above row 2047 use wide 32-bit events (row << 13) | cnt."""
    return M > 2048


def compact_words(M: int) -> int:
    """Event WORDS on the wire for an M-row bucket."""
    E = compact_E(M)
    return E if compact_wide(M) else E // 2


def compact_encode(steps, term, si, sd, score):
    """Pack per-row step words + terminals into the compact wire
    (lamsa_tpu/ops/banded_sw.py compact_encode, byte for byte):
    int32[B, M/32 + compact_words(M) + 3] =
      [ op bitmap (bit = DP row index, 1 = I step)
      | D events, row-ascending, 0xFFFF / 0x7FFFFFFF padding
      | term0 | n_ev << 16, si | sd << 16, score ]
    n_ev is 0xFFFF when a D run is too long for its count field."""
    B, M = steps.shape
    E = compact_E(M)
    dev = steps.device
    i64 = torch.int64
    steps = steps.to(i64)
    si = si.to(i64)
    idxr = torch.arange(M, dtype=i64, device=dev)[None, :]
    active = idxr < si[:, None]          # rows the walk visited
    op = steps >> 16
    cnt = steps & 0xFFFF
    ibit = (active & (op == 1)).to(i64)
    shifts = torch.arange(32, dtype=i64, device=dev)[None, None, :]
    opbits = to_i32((ibit.reshape(B, M // 32, 32) << shifts).sum(dim=2))
    ev = active & (cnt > 0) & (op != 2)
    if compact_wide(M):
        big = ev & (cnt > 8191)          # 13-bit wide count field
        evw = torch.where(ev & ~big, (idxr << 13) | cnt, 0x7FFFFFFF)
        evw = torch.sort(evw, dim=1).values[:, :E].to(torch.int32)
    else:
        big = ev & (cnt > 30)            # run too long for the 5-bit cnt
        evh = torch.where(ev & ~big, (idxr << 5) | cnt, 0xFFFF)
        evh = torch.sort(evh, dim=1).values[:, :E]
        pair = evh.reshape(B, E // 2, 2)
        evw = to_i32(pair[:, :, 0] | (pair[:, :, 1] << 16))
    n_ev = ev.sum(dim=1)
    n_ev = torch.where(big.any(dim=1), 0xFFFF, n_ev)
    tail = torch.stack(
        [to_i32(term[:, 0].to(i64) | (n_ev << 16)),
         to_i32(si | (sd.to(i64) << 16)), to_i32(score)], dim=1)
    return torch.cat([opbits, evw, tail], dim=1)


def collect_group(packed, M, topdown=False):
    """Decode one chunk's compact wire (a tensor on any device) on the
    host with the native decoder. Returns (cigars, score, si, sd);
    cigars[b] is None where the event list overflowed on device (the
    caller recomputes those).

    topdown: the antidiagonal walker writes D events row-DESCENDING from
    slot 0; each instance's first n_ev slots are reversed here so the
    shared row-ascending decoder applies unchanged
    (lamsa_tpu/ops/banded_sw.py collect_group_pallas)."""
    from lamsa_tpu_torch import native

    nw = M // 32
    Ew = compact_words(M)
    wide = compact_wide(M)
    packed = to_host(packed)
    opbits = packed[:, :nw]
    events = packed[:, nw:nw + Ew]
    tail = packed[:, nw + Ew:]
    term0 = tail[:, 0] & 0xFFFF
    n_ev = (tail[:, 0] >> 16) & 0xFFFF   # 0xFFFF = overflow sentinel
    si = tail[:, 1] & 0xFFFF
    sd = tail[:, 1] >> 16
    score = tail[:, 2]
    if topdown:
        items = np.ascontiguousarray(events, np.int32)
        if not wide:
            items = items.view(np.uint16)
        E = items.shape[1]
        idx = np.arange(E)[None, :]
        nv = n_ev[:, None]
        perm = np.where(idx < nv, np.clip(nv - 1 - idx, 0, E - 1), idx)
        items = np.take_along_axis(items, perm, axis=1)
        events = items if wide else items.view(np.int32)
    cigars = native.decode_compact_batch(opbits, events, term0, si, n_ev,
                                         wide=wide)
    return cigars, score, si, sd
