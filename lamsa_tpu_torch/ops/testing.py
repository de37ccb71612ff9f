"""Seeded numpy DP test batches for the DP kernels, shared by the
kernel tests and ``chip_smoke.py``.

  make_batch        global instances: a random target and a mutated
                    copy as query, band centred on both diagonals
  make_zdrop_batch  extension-shaped instances (lo = -W/2) whose query
                    carries a block of N codes, so the score dips and
                    zdrop 30 / 60 / 150 fires on many of them
  make_globals      global instances with an EVEN lo for the
                    antidiagonal pair (targets with N codes, indels);
                    optionally the last two are a 35-base deletion (a D
                    run too long for the narrow event count) and an
                    indel ladder (more D events than event slots)
  unpack_rows       dirs32 int32[B, M/4, W] -> direction bytes [B, M, W]
  make_deletion_batch
                    global instances with an even lo whose query lacks
                    one run of W/2 - 16 target bases: the E chain of
                    that gap crosses every thread edge of the DP
                    kernels' lane split on its way
  edge_batch        B - 1 instances of make_batch or make_globals and
                    one of make_deletion_batch, concatenated
  make_global_chunk packed read / reference words and a descriptor wire
                    of make_globals instances on both read strands
  adiag_live        which dirs32a words lie below each instance's m + n
  port_world        this package's own reference, index and config for
                    another package's (the tests that compare the port
                    with the JAX package build both sides from the same
                    codes)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lamsa_tpu_torch.ops.wire import (_LO_BIAS, global_lo, pack_codes_words,
                                      pack_desc)

T_SENTINEL = 5                  # t_win code outside the target


def prepare_band(m: int, n: int, W: int) -> int:
    """Centred band lo for a global m x n instance."""
    need = abs(n - m) + 1
    return min(0, n - m) - (W - need) // 2


def make_t_window(t, lo: int, M: int, W: int) -> np.ndarray:
    """t_win[x] = t[x + lo], sentinel outside t, length M + W."""
    out = np.full(M + W, T_SENTINEL, np.int32)
    s, e = max(0, lo), min(len(t), lo + M + W)
    if e > s:
        out[s - lo:e - lo] = t[s:e]
    return out


def make_batch(rng, B: int, M: int, W: int):
    """Global DP instances: (q, t_win, m, n, lo) int32 arrays."""
    q = np.zeros((B, M), np.int32)
    t_win = np.zeros((B, M + W), np.int32)
    m_len = np.zeros(B, np.int32)
    n_len = np.zeros(B, np.int32)
    lo = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(8, M - 2))
        t = rng.integers(0, 4, n).astype(np.uint8)
        q_list = list(t)
        for _ in range(int(rng.integers(0, max(2, n // 8)))):
            k = int(rng.integers(0, max(1, len(q_list))))
            r = rng.random()
            if r < 0.4 and q_list:
                q_list[k] = int(rng.integers(0, 4))
            elif r < 0.7:
                q_list.insert(k, int(rng.integers(0, 4)))
            elif q_list:
                del q_list[k]
        qq = np.array(q_list[:M], np.uint8)
        if len(qq) == 0 or abs(n - len(qq)) + 1 > W - 8:
            qq = t[:M].copy()
        m_len[b], n_len[b] = len(qq), n
        lo[b] = prepare_band(len(qq), n, W)
        q[b, :len(qq)] = qq
        t_win[b] = make_t_window(t, int(lo[b]), M, W)
    return q, t_win, m_len, n_len, lo


def make_zdrop_batch(rng, B: int, M: int, W: int):
    """Extension instances with an N block: (q, t_win, m, n, lo, zdrop)
    int32 arrays, zdrop drawn from {0, 30, 60, 150}."""
    q = np.zeros((B, M), np.int32)
    t_win = np.zeros((B, M + W), np.int32)
    m_len = np.zeros(B, np.int32)
    n_len = np.zeros(B, np.int32)
    lo = np.full(B, -(W // 2), np.int32)
    zdrop = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(M // 2, M - 8))
        t = rng.integers(0, 4, n).astype(np.uint8)
        qq = t.copy()
        a = int(rng.integers(n // 8, n // 3))
        ln = int(rng.integers(16, 96))
        qq[a:a + ln] = 4
        m_len[b] = n_len[b] = n
        q[b, :n] = qq
        t_win[b] = make_t_window(t, int(lo[b]), M, W)
        zdrop[b] = int(rng.choice([0, 30, 60, 150]))
    return q, t_win, m_len, n_len, lo, zdrop


def _even_lo(m: int, n: int, W: int) -> int:
    lo = prepare_band(m, n, W)
    return lo - (lo & 1)


def make_globals(rng, B: int, M: int, W: int, stress: bool = False):
    """Global instances with even lo: (q, t_win, m, n, lo) int32 arrays
    (the recipe of tests/test_banded_sw_adiag.py make_globals). With
    stress, instance B-2 deletes 35 target bases in one run and
    instance B-1 deletes every 5th target base, inserting 20 bases
    after each 20 deletions so the drift stays inside the band."""
    q = np.zeros((B, M), np.int32)
    t_win = np.zeros((B, M + W), np.int32)
    m_len = np.zeros(B, np.int32)
    n_len = np.zeros(B, np.int32)
    lo = np.zeros(B, np.int32)
    for b in range(B):
        if stress and b >= B - 2:
            t = rng.integers(0, 4, M - 8).astype(np.int32)
            if b == B - 2:
                a = int(rng.integers(1, len(t) // 2))
                qq = np.concatenate([t[:a], t[a + 35:]])
            else:
                ql = []
                for k, c in enumerate(t):
                    if k % 5 == 4:
                        if k % 100 == 99 and k + 100 < len(t):
                            # 20 deletions so far: re-centre
                            ql.extend(rng.integers(0, 4, 20).tolist())
                        continue
                    ql.append(int(c))
                qq = np.array(ql[:M], np.int32)
        else:
            m = int(rng.integers(1, M + 1))
            t = rng.integers(0, 5, m).astype(np.int32)      # incl. N = 4
            ql = list(t)
            for _ in range(int(rng.integers(0, max(2, m // 12)))):
                k = int(rng.integers(0, max(1, len(ql))))
                r = rng.random()
                if r < 0.4 and ql:
                    ql[k] = int(rng.integers(0, 4))
                elif r < 0.7:
                    ql.insert(k, int(rng.integers(0, 4)))
                elif ql:
                    del ql[k]
            qq = np.array(ql[:M], np.int32)
            if len(qq) == 0:
                qq = t[:1].copy()
            if abs(len(t) - len(qq)) + 1 > W - 2:
                qq = t.copy()
        m_len[b], n_len[b] = len(qq), len(t)
        lo[b] = _even_lo(len(qq), len(t), W)
        q[b, :len(qq)] = qq
        t_win[b] = make_t_window(t, int(lo[b]), M, W)
    return q, t_win, m_len, n_len, lo


def make_deletion_batch(rng, B: int, M: int, W: int):
    """Global instances (even lo) whose query deletes W/2 - 16
    consecutive target bases: (q, t_win, m, n, lo) int32 arrays."""
    dels = W // 2 - 16
    q = np.zeros((B, M), np.int32)
    t_win = np.zeros((B, M + W), np.int32)
    m_len = np.zeros(B, np.int32)
    n_len = np.zeros(B, np.int32)
    lo = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(dels + 8, M + dels - 2))
        t = rng.integers(0, 4, n).astype(np.int32)
        a = int(rng.integers(1, n - dels))
        qq = np.concatenate([t[:a], t[a + dels:]])
        m_len[b], n_len[b] = len(qq), n
        lo[b] = _even_lo(len(qq), n, W)
        q[b, :len(qq)] = qq
        t_win[b] = make_t_window(t, int(lo[b]), M, W)
    return q, t_win, m_len, n_len, lo


def edge_batch(rng, B: int, M: int, W: int, adiag: bool = False):
    """B - 1 instances of make_globals (adiag) or make_batch, then one
    of make_deletion_batch: (q, t_win, m, n, lo) int32 arrays."""
    make = make_globals if adiag else make_batch
    parts = [make(rng, B - 1, M, W), make_deletion_batch(rng, 1, M, W)]
    return tuple(np.concatenate(x) for x in zip(*parts))


def _revcomp(codes):
    return np.where(codes < 4, 3 - codes, codes)[::-1].astype(np.uint8)


def make_global_chunk(rng, M: int, W: int, K: int, Bp: int):
    """Packed read / reference words and a (Bp, 4) descriptor wire of K
    global gap fills on both read strands (mutated copies of reference
    windows, the last two with a 35-base deletion and a deletion ladder)
    plus padding rows."""
    span = M + W + 16
    ref = rng.integers(0, 4, K * span + span).astype(np.uint8)
    q0, tw0, m, n, _ = make_globals(rng, K, M, W, stress=True)
    reads, cols = [], {k: [] for k in ("qb", "qs", "qc", "tb")}
    off = 0
    for k in range(K):
        # the target of make_globals (N codes included) at its own place
        # in the reference, the mutated query in the reads
        tb = k * span + int(rng.integers(0, 16))
        ref[tb:tb + n[k]] = tw0[k][tw0[k] != 5][:n[k]]
        qq = q0[k, :m[k]].astype(np.uint8)
        strand = k % 2
        reads.append(qq if strand == 0 else _revcomp(qq))
        qd = (off, 1, 0) if strand == 0 else (off + m[k] - 1, -1, 1)
        for key, v in zip(("qb", "qs", "qc"), qd):
            cols[key].append(v)
        cols["tb"].append(tb)
        off += int(m[k])
    m64, n64 = m.astype(np.int64), n.astype(np.int64)
    lo = global_lo(m64, n64, W)
    desc = np.zeros((Bp, 4), np.int32)
    desc[K:, 3] = _LO_BIAS                      # padding: m = n = 0
    desc[:K] = pack_desc(cols["qb"], cols["qs"], cols["qc"], cols["tb"],
                         np.ones(K, np.int64), m64, n64, lo, np.ones(K, bool),
                         np.zeros(K, np.int64))
    return (pack_codes_words(np.concatenate(reads)), pack_codes_words(ref),
            desc)


def adiag_live(m_len, n_len, A4: int):
    """bool[B, A4, 1]: dirs32a words w with 4w < m + n (steps the
    instance computes; words above are unspecified)."""
    w = torch.arange(A4, device=m_len.device)[None, :, None]
    return 4 * w < (m_len + n_len).to(torch.int64)[:, None, None]


def unpack_rows(dirs32):
    """int32[B, M/4, W] -> uint8[B, M, W] direction bytes (row-major)."""
    B, M4, W = dirs32.shape
    return dirs32.contiguous().view(torch.uint8).reshape(B, M4, W, 4) \
        .permute(0, 1, 3, 2).reshape(B, M4 * 4, W)


def port_world(ref, index=None, config=None):
    """This package's PackedReference (and index, and AlignConfig) for a
    reference, index and config of another package: the reference from
    the same codes, the index built anew from them with the same k or
    sa_rate and checked to hold the same arrays, the config from the
    same values. The Aligner tells its index kinds apart with
    isinstance, so it must be handed this package's own classes."""
    from lamsa_tpu_torch.config import AlignConfig, ScoreParams
    from lamsa_tpu_torch.index.fmindex import FmIndex
    from lamsa_tpu_torch.index.kmer import KmerIndex
    from lamsa_tpu_torch.io.refpack import PackedReference

    out = [PackedReference(names=list(ref.names),
                           offsets=np.asarray(ref.offsets),
                           codes=np.asarray(ref.codes),
                           amb_runs=np.asarray(ref.amb_runs))]
    if index is not None:
        if hasattr(index, "sa_rate"):
            own = FmIndex.build(out[0].codes, sa_rate=index.sa_rate)
        else:
            own = KmerIndex.build(out[0].codes, index.k)
        for f in dataclasses.fields(own):
            a, b = getattr(own, f.name), getattr(index, f.name)
            if not (np.array_equal(a, b) if isinstance(a, np.ndarray)
                    else a == b):
                raise ValueError(f"port_world: the rebuilt index differs "
                                 f"in {f.name}")
        out.append(own)
    if config is not None:
        values = dataclasses.asdict(config)
        values["scores"] = ScoreParams(**values["scores"])
        out.append(AlignConfig(**values))
    return tuple(out)
