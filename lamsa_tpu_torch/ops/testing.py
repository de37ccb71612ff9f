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
  make_indel_batch  global instances with one long deletion or one long
                    insertion run each, for the walkers' tile edges
  random_dirs       direction words of random nibbles: walks with long D
                    and I runs that leave the band
  traceback_adiag_tiled, traceback_row_tiled
                    numpy mirrors of the tile schedule of the two CUDA
                    walkers (csrc/traceback_adiag.cu, csrc/traceback_row.cu;
                    constants from _build.WALK_TILES): the same tiles staged
                    by the same rules, every byte read from the staged tile
                    or TileReadError raised, and the counts of tiles staged
                    and of blocking reloads
  walker_edge_walks walks over gaps, mixed instances and random words that
                    cross the walkers' tile edges and leave the band
  walker_counts_cuda
                    the CUDA walkers launched with their debug output: the
                    kernel's own counts of tiles staged and blocking reloads
  port_world        this package's own reference, index and config for
                    another package's (the tests that compare the port
                    with the JAX package build both sides from the same
                    codes)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lamsa_tpu_torch import _build
from lamsa_tpu_torch.ops.wire import (_LO_BIAS, compact_E, compact_wide,
                                      compact_words, global_lo,
                                      pack_codes_words, pack_desc)

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


def make_indel_batch(rng, B: int, M: int, W: int, dels: int, ins: int):
    """Global instances (even lo) with one long gap each: the query of
    an even instance lacks one run of `dels` target bases, the query of
    an odd instance carries one run of `ins` bases the target lacks
    (both in one instance, the DP would pair the two runs off as short
    gaps and matches). (q, t_win, m, n, lo) int32 arrays; needs
    max(dels, ins) + 1 <= W - 2 and M >= ins + 32."""
    q = np.zeros((B, M), np.int32)
    t_win = np.zeros((B, M + W), np.int32)
    m_len = np.zeros(B, np.int32)
    n_len = np.zeros(B, np.int32)
    lo = np.zeros(B, np.int32)
    for b in range(B):
        gap_t, gap_q = (dels, 0) if b % 2 == 0 else (0, ins)
        m = int(rng.integers(max(gap_q + 24, M // 2), M - 2))
        rest = m - gap_q                        # bases on both sides
        h0 = int(rng.integers(8, rest - 7))
        t = rng.integers(0, 4, rest + gap_t).astype(np.int32)
        qq = np.concatenate([t[:h0], rng.integers(0, 4, gap_q),
                             t[h0 + gap_t:]]).astype(np.int32)
        m_len[b], n_len[b] = len(qq), len(t)
        lo[b] = _even_lo(len(qq), len(t), W)
        q[b, :len(qq)] = qq
        t_win[b] = make_t_window(t, int(lo[b]), M, W)
    return q, t_win, m_len, n_len, lo


def random_dirs(rng, B: int, R4: int, L: int):
    """int32[B, R4, L] direction words of random nibbles (source M / D /
    I / stop with weights 0.658 / 0.17 / 0.17 / 0.002, each extension
    bit set with probability 0.9): no DP wrote them, so a walk over them
    takes long D and I runs, leaves the band on either side and, on the
    antidiagonal layout, may stop early."""
    src = rng.choice(4, size=(B, R4, L, 4), p=[0.658, 0.17, 0.17, 0.002])
    ext = (rng.random((B, R4, L, 4, 2)) < 0.9).astype(np.int64)
    nib = src | (ext[..., 0] << 2) | (ext[..., 1] << 3)
    words = (nib << (8 * np.arange(4))).sum(axis=-1)
    return words.astype(np.uint32).view(np.int32)


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


SIGN_LINE = 1 << 31             # reference positions from here set bit 31


def _word_patch(pos: int, codes) -> tuple[int, np.ndarray]:
    """(first word, int32 words) holding ``codes`` at reference position
    ``pos``, N codes on the rest of the first and last words."""
    w0 = pos >> 3
    run = np.full(pos - 8 * w0, 4, np.uint8)
    return w0, pack_codes_words(np.concatenate([run, codes]))


def make_high_chunk(rng, genome_len: int, M: int, W: int, K: int):
    """A chunk of K global gap fills (make_globals) and K end extensions
    (make_zdrop_batch; every odd one leftward, reading its target
    downward) whose targets lie past SIGN_LINE in a reference of
    genome_len codes. The first global starts 8 codes past the line, so
    its band head reaches below it, and the second ends at the
    reference's last code. The same instances are also placed at low
    coordinates, each at a slot of its own in a small reference.

    Returns (flat, patches, desc, low_ref, low_desc): the packed read
    words, the reference patches [(first word, int32 words)] to write
    into genome-sized reference words (whatever else those hold is
    outside every target), the (2K, 4) descriptor wire (globals first,
    is_global set, extensions with bonus 5), the small reference's words
    and the wire that reads the same targets from it."""
    qg, twg, mg, ng, _ = make_globals(rng, K, M, W)
    qe, twe, me, ne, loe, _ = make_zdrop_batch(rng, K, M, W)
    targets = [twg[k][twg[k] != T_SENTINEL][:ng[k]] for k in range(K)]
    targets += [twe[k][-int(loe[k]):-int(loe[k]) + ne[k]] for k in range(K)]
    queries = [qg[k, :mg[k]] for k in range(K)] + \
        [qe[k, :me[k]] for k in range(K)]
    m = np.concatenate([mg, me]).astype(np.int64)
    n = np.concatenate([ng, ne]).astype(np.int64)
    ts = np.array([1] * K + [1 - 2 * (k % 2) for k in range(K)], np.int64)
    span = -(-(M + W + 64) // 8) * 8
    n_slots = (genome_len - SIGN_LINE) // span - 1
    low = SIGN_LINE + span * (rng.choice(n_slots - 1, 2 * K, replace=False)
                              + 1) + rng.integers(0, 8, 2 * K)
    low[0] = SIGN_LINE + 8
    low[1] = genome_len - n[1]
    patches, low_patches, tb, low_tb = [], [], [], []
    for i, t in enumerate(targets):
        t = np.asarray(t, np.uint8)
        ref_order = t if ts[i] > 0 else t[::-1]   # codes by ascending pos
        patches.append(_word_patch(int(low[i]), ref_order))
        low_pos = span * (i + 1) + int(low[i]) % 8
        low_patches.append(_word_patch(low_pos, ref_order))
        first = 0 if ts[i] > 0 else n[i] - 1      # t_base: gather index 0
        tb.append(int(low[i]) + first)
        low_tb.append(low_pos + first)
    low_ref = np.zeros(span * (2 * K + 2) // 8, np.int32)
    for w0, words in low_patches:
        low_ref[w0:w0 + len(words)] = words
    qb = np.concatenate([[0], np.cumsum(m)[:-1]])
    glob = np.arange(2 * K) < K
    lo = np.where(glob, global_lo(m, n, W), -(W // 2))
    cols = (qb, np.ones(2 * K, np.int64), np.zeros(2 * K, np.int64))
    rest = (ts, m, n, lo, glob, np.where(glob, 0, 5))
    flat = pack_codes_words(np.concatenate(queries).astype(np.uint8))
    return (flat, patches, pack_desc(*cols, np.array(tb), *rest), low_ref,
            pack_desc(*cols, np.array(low_tb), *rest))


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


# ------------------------------ the CUDA walkers' tile schedule, mirrored

class TileReadError(AssertionError):
    """A mirrored walker read a direction byte outside its staged tile."""


class _TileBuf:
    """One shared-memory tile buffer of a mirrored walker: the words of
    tile t (word rows [t * TR, (t + 1) * TR)) at lane origin l0 that lie
    inside the instance's array; no other word can be read."""

    def __init__(self, words, TR, TL):
        self.words, self.TR, self.TL = words, TR, TL
        self.t = self.l0 = None

    def stage(self, t, l0):
        if l0 % 4:
            raise TileReadError(f"tile origin {l0} is not 16-byte aligned")
        R, L = self.words.shape
        self.t, self.l0 = t, l0
        self.ok = np.zeros((self.TR, self.TL), bool)
        self.data = np.zeros((self.TR, self.TL), np.int64)
        if t < 0:
            return
        r0, r1 = t * self.TR, min((t + 1) * self.TR, R)
        g0, g1 = max(l0, 0), min(l0 + self.TL, L)
        if r1 > r0 and g1 > g0:
            self.ok[:r1 - r0, g0 - l0:g1 - l0] = True
            self.data[:r1 - r0, g0 - l0:g1 - l0] = self.words[r0:r1, g0:g1]

    def byte(self, wr, lane, k):
        rr, x = wr - self.t * self.TR, lane - self.l0
        if not (0 <= rr < self.TR and 0 <= x < self.TL and self.ok[rr, x]):
            raise TileReadError(f"read of word ({wr}, {lane}) outside tile "
                                f"{self.t} at origin {self.l0}")
        return (int(self.data[rr, x]) >> (8 * k)) & 0xFF


def _origin(lane, left):
    return (lane - left) & ~3


def _walk_adiag_tiled(words, si, sd, hl, M):
    """One instance of csrc/traceback_adiag.cu, statement for statement:
    (opbits, events, term0, n_ev, tiles staged, blocking reloads)."""
    TR, TL, LEFT = (_build.WALK_TILES[f"ADIAG_TILE_{k}"]
                    for k in ("ROWS", "LANES", "LEFT"))
    A4, V = words.shape
    A, NW, EW = 4 * A4, M // 32, compact_words(M)
    wide, e_slots = compact_wide(M), compact_E(M)
    CMAX, RSH = (8191, 13) if wide else (30, 5)
    op = np.zeros(NW, np.int64)
    ev = np.zeros(EW, np.int64)
    sj = si + 2 * hl + sd
    sa = si + sj
    i, l = si, (sd - (sa & 1)) >> 1
    mode = pend = evc = ovf = 0
    term0 = sj if si == 0 else 0
    acur = 0 if si == 0 else sa
    evw, opk, opw = 0, -1, 0        # words gathered before they are stored
    n_stage = n_block = 0

    def emit_event(row, cnt):
        nonlocal evw, evc, ovf
        val = ((row - 1) << RSH) | min(cnt, CMAX)
        if wide:
            if evc < EW:
                ev[evc] = val
        else:
            evw = (evw | (val << 16)) if evc & 1 else val
            if evc >> 1 < EW:
                ev[evc >> 1] = evw
        if cnt > CMAX or evc >= e_slots:
            ovf = 1
        evc += 1

    if 1 <= acur <= A and i >= 1:
        t = ((acur - 1) >> 2) // TR
        bufs = [_TileBuf(words, TR, TL), _TileBuf(words, TR, TL)]
        cur, l_in = 0, l
        l0c = l0n = _origin(l, LEFT)
        bufs[0].stage(t, l0c)
        bufs[1].stage(t - 1, l0n)
        n_stage += 1 + (t > 0)
        while True:
            tb = bufs[cur]
            a_lo = 4 * t * TR + 1
            while True:
                if not (acur >= 1 and i >= 1):
                    reason = 0
                    break
                if acur < a_lo:
                    reason = 1
                    break
                a = acur
                in_band = 0 <= l < V
                if in_band and not 0 <= l - l0c < TL:
                    reason = 2
                    break
                if mode == 0:
                    # up to 32 steps at once: lane k looks at
                    # antidiagonal a - 2k
                    run = 0
                    while run < 32 and a - 2 * run >= a_lo and (
                            not in_band or tb.byte(
                                (a - 2 * run - 1) >> 2, l,
                                (a - 2 * run - 1) & 3) & 3 == 0):
                        run += 1
                    run = min(run, i - 1)
                    if run > 0:
                        if pend > 0:
                            emit_event(i, pend)
                            pend = 0
                        i -= run
                        acur -= 2 * run
                        if run == 32 or acur < a_lo:
                            continue
                        a = acur        # the serial step follows at once
                nib = tb.byte((a - 1) >> 2, l, (a - 1) & 3) & 0xF \
                    if in_band else 0
                src, eext, fext = nib & 3, (nib >> 2) & 1, (nib >> 3) & 1
                isE = mode == 1 or (mode == 0 and src == 1)
                isF = mode == 2 or (mode == 0 and src == 2)
                isM = mode == 0 and src == 0
                if not (isE or isF or isM):
                    reason = 0
                    break
                commit = isM or isF
                widx = (i - 1) >> 5
                if isF and widx < NW:
                    if widx != opk:
                        if opk >= 0:
                            op[opk] = opw
                        opk, opw = widx, 0
                    opw |= 1 << ((i - 1) & 31)
                if commit and pend > 0:
                    emit_event(i, pend)
                pend = pend + 1 if isE else 0
                if a & 1 == 0:
                    l -= int(isE)
                else:
                    l += int(isF)
                mode = (1 if eext else 0) if isE else \
                    ((2 if fext else 0) if isF else 0)
                if commit:
                    i -= 1
                a2 = a - (2 if isM else 1)
                if commit and i == 0:
                    term0, acur = a2, 0
                else:
                    acur = a2
            if reason == 0:
                break
            if reason == 1:
                t -= 1
                cur ^= 1
                drift, l_in = l - l_in, l
                l0c = l0n
                if 0 <= l < V and not l0c <= l < l0c + TL:
                    l0c = _origin(l, LEFT)
                    bufs[cur].stage(t, l0c)
                    n_stage += 1
                    n_block += 1
                l0n = _origin(l + drift, LEFT)
                bufs[cur ^ 1].stage(t - 1, l0n)
                n_stage += t > 0
            else:
                l0c = _origin(l, LEFT)
                bufs[cur].stage(t, l0c)
                n_stage += 1
                n_block += 1
    if opk >= 0:
        op[opk] = opw
    return op, ev, term0, (0xFFFF if ovf else evc), n_stage, n_block


def traceback_adiag_tiled(dirs32a, si, sd, hl, *, M):
    """traceback_adiag by the CUDA kernel's tile schedule, in numpy on
    the host: (opbits, events, term0, n_ev) as traceback_adiag returns
    them, and counts int32[B, 2] = tiles staged, blocking reloads."""
    words = dirs32a.cpu().numpy().view(np.uint32)
    outs = [_walk_adiag_tiled(words[b], int(si[b]), int(sd[b]), int(hl[b]), M)
            for b in range(words.shape[0])]

    def i32(k):
        return torch.from_numpy(np.array([o[k] for o in outs], np.int64)
                                .astype(np.uint32).view(np.int32))

    counts = torch.stack([i32(4), i32(5)], dim=1)
    return (i32(0), i32(1), i32(2), i32(3)), counts


def _walk_row_tiled(words, lo, si, sd):
    """One instance of csrc/traceback_row.cu, statement for statement:
    (steps, term, tiles staged, blocking reloads)."""
    TR, TL, LEFT = (_build.WALK_TILES[f"ROW_TILE_{k}"]
                    for k in ("ROWS", "LANES", "LEFT"))
    M4, W = words.shape
    M = 4 * M4
    INACT = 2 << 16
    st = np.full(M, -1, np.int64)               # every word must be stored
    first = (((si - 1) >> 5) + 1 if si >= 1 else 0) * 32
    st[first:] = INACT
    mystep = [INACT] * 32
    d = sd
    n_stage = n_block = 0
    if si >= 1:
        r, in_f, scanning, y, count = si, 0, False, 0, 0
        t = ((r - 1) >> 2) // TR
        bufs = [_TileBuf(words, TR, TL), _TileBuf(words, TR, TL)]
        cur, d_in = 0, d
        l0c = l0n = _origin(d, LEFT)
        bufs[0].stage(t, l0c)
        bufs[1].stage(t - 1, l0n)
        n_stage += 1 + (t > 0)
        while True:
            tb = bufs[cur]
            r_lo = 4 * t * TR + 1
            while True:
                if r < 1:
                    reason = 0
                    break
                if r < r_lo:
                    reason = 1
                    break
                wr, k4 = (r - 1) >> 2, (r - 1) & 3
                bx, x, up_known = 0, d, False
                if not scanning:
                    in_band = 0 <= d < W
                    if in_band and not 0 <= d - l0c < TL:
                        reason = 2
                        break
                    if not in_f:
                        # 32 rows at once: lane k looks at row r - k
                        p = (r - 1) & 31
                        run = 0
                        while run < 32 and r - run >= r_lo and (
                                not in_band or tb.byte(
                                    (r - run - 1) >> 2, d,
                                    (r - run - 1) & 3) & 3 == 0):
                            run += 1
                        run = min(run, p + 1)
                        if run > 0:
                            for j in range(p - run + 1, p + 1):
                                mystep[j] = 0
                            r -= run
                            if run == p + 1:
                                n = min(32, M - r)
                                st[r:r + n] = mystep[:n]
                                mystep = [INACT] * 32
                                continue
                            if r < r_lo:
                                continue
                            # the serial row follows at once
                            wr, k4 = (r - 1) >> 2, (r - 1) & 3
                    bd = tb.byte(wr, d, k4) if in_band else 0
                    if in_f:
                        op, newlane, newf = 1, d + 1, (bd >> 3) & 1
                        count, up_known = 0, True
                    else:
                        count = int(bd & 3 == 1)
                        if count:
                            scanning, y = True, d - 1
                        else:
                            bx = bd & 0xF
                if scanning:
                    miss = False
                    while y >= 0:
                        xy = y - l0c
                        if xy < 0 or xy + 1 >= TL:
                            miss = True
                            break
                        is_e = tb.byte(wr, y, k4) & 3 == 1
                        e_up = (tb.byte(wr, y + 1, k4) >> 2) & 1
                        if not (is_e or e_up):
                            break
                        count += 1
                        y -= 1
                    if miss:
                        reason = 3
                        break
                    scanning = False
                    x = y
                    bx = tb.byte(wr, x, k4) & 0xF if x >= 0 else 0
                if not up_known:
                    if bx & 3 == 0:
                        op, newlane, newf = 0, x, 0
                    else:
                        op, newlane, newf = 1, x + 1, (bx >> 3) & 1
                k = r - 1
                mystep[k & 31] = count | (op << 16)
                if k & 31 == 0:
                    n = min(32, M - k)
                    st[k:k + n] = mystep[:n]
                    mystep = [INACT] * 32
                d, in_f = newlane, newf
                r -= 1
            if reason == 0:
                break
            if reason == 1:
                t -= 1
                cur ^= 1
                drift, d_in = d - d_in, d
                l0c = l0n
                if 0 <= d < W and not l0c <= d < l0c + TL:
                    l0c = _origin(d, LEFT)
                    bufs[cur].stage(t, l0c)
                    n_stage += 1
                    n_block += 1
                l0n = _origin(d + drift, LEFT)
                bufs[cur ^ 1].stage(t - 1, l0n)
                n_stage += t > 0
            else:
                l0c = _origin(d, LEFT) if reason == 2 \
                    else (y + 2 - TL + 3) & ~3
                bufs[cur].stage(t, l0c)
                n_stage += 1
                n_block += 1
    if (st < 0).any():
        raise TileReadError("a step word was never stored")
    term = np.zeros(8, np.int64)
    term[0] = lo + d
    term[1] = d if si >= 1 else 0
    return st, term, n_stage, n_block


def traceback_row_tiled(dirs32, lo, start_i, start_d):
    """traceback_row by the CUDA kernel's tile schedule, in numpy on the
    host: (steps, term) as traceback_row returns them, and counts
    int32[B, 2] = tiles staged, blocking reloads."""
    words = dirs32.cpu().numpy().view(np.uint32)
    outs = [_walk_row_tiled(words[b], int(lo[b]), int(start_i[b]),
                            int(start_d[b])) for b in range(words.shape[0])]

    def i32(k):
        return torch.from_numpy(np.array([o[k] for o in outs], np.int64)
                                .astype(np.int32))

    return (i32(0), i32(1)), torch.stack([i32(2), i32(3)], dim=1)


def walker_counts_cuda(kind, dirs, *starts, M=None):
    """Launch a CUDA walker through its C entry with the debug output
    (not through its wrapper, so no launch is counted). kind "row":
    starts = (lo, start_i, start_d); kind "adiag": starts = (si, sd, hl)
    and M. Returns (the wrapper's outputs, counts int32[B, 2] = tiles
    staged, blocking reloads, as the kernel counted them)."""
    dev = dirs.device
    B = dirs.shape[0]
    ptrs = [x.data_ptr() for x in (dirs, *starts)]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    # the C entries launch on the runtime's current device: the inputs'
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counts = torch.zeros((B, 2), dtype=torch.int32, device=dev)
        if kind == "row":
            _, M4, W = dirs.shape
            outs = (empty(B, 4 * M4), empty(B, 8))
            rc = _build.lib().lamsa_traceback_row(
                *ptrs, *(o.data_ptr() for o in outs), counts.data_ptr(), B,
                4 * M4, W, stream)
        else:
            _, A4, V = dirs.shape
            EW = compact_words(M)
            outs = (empty(B, M // 32), empty(B, EW), empty(B), empty(B))
            rc = _build.lib().lamsa_traceback_adiag(
                *ptrs, *(o.data_ptr() for o in outs), counts.data_ptr(), B,
                A4, V, M, EW, int(compact_wide(M)), compact_E(M), stream)
    _build.check(rc, f"lamsa_traceback_{kind}")
    return outs, counts


def walker_edge_walks(rng, B: int, M: int, W: int, dev,
                      kinds=("row", "adiag"), **scores):
    """Walks built to cross the walkers' tile edges, on device `dev`
    (the DP wrappers make the direction words: the kernels on a card,
    the plain versions on the CPU). Yields (name, kind, walk): kind
    "row" with walk = (dirs32, lo, start_i, start_d), or "adiag" with
    walk = (dirs32a, si, sd, hl); only the kinds asked for. Per kind:
      gap     make_indel_batch: a deletion of W/2 + 8 bases (past the
              row walker's lane window) or an insertion of 40 (past 32
              rows), global walks from (m, n);
      edge    edge_batch: mixed instances and one W/2 - 16 deletion;
      random  random_dirs: long D and I runs, cursors that leave the
              band on both sides, starts outside the band, at row 0 and
              (adiag) past the padded steps."""
    from lamsa_tpu_torch.ops.banded_sw_adiag import banded_sw_adiag
    from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row
    from lamsa_tpu_torch.ops.wire import a_pad

    def on_dev(arrs):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrs]

    for name, batch in (
            ("gap", make_indel_batch(rng, B, M, W, W // 2 + 8, 40)),
            ("edge", edge_batch(rng, B, M, W, adiag=True))):
        q, t_win, m, n, lo = on_dev(batch)
        sd = (n - m - lo).contiguous()
        if "row" in kinds:
            row = banded_sw_row(q, t_win, m, n, lo, torch.zeros_like(m),
                                **scores)
            yield name, "row", (row["dirs32"], lo, m.clone(), sd)
        if "adiag" in kinds:
            ad = banded_sw_adiag(q, t_win, m, n, lo, **scores)
            yield name, "adiag", (ad["dirs32a"], m, sd,
                                  (lo >> 1).contiguous())
    i32 = np.int32
    if "row" in kinds:
        dirs, lo, si, sd = on_dev([
            random_dirs(rng, B, M // 4, W),
            rng.integers(-W, 0, B).astype(i32),
            rng.integers(1, M + 1, B).astype(i32),
            rng.integers(-8, W + 8, B).astype(i32)])
        si[0] = M
        if B > 1:
            si[1] = 0
        yield "random", "row", (dirs, lo, si, sd)
    if "adiag" not in kinds:
        return
    dirs_a, si, sd, hl = on_dev([
        random_dirs(rng, B, a_pad(M, W) // 4, W // 2),
        rng.integers(1, M + 1, B).astype(i32),
        rng.integers(-8, W + 8, B).astype(i32),
        rng.integers(-W // 4, 1, B).astype(i32)])
    si[0] = M
    if B > 2:
        si[1] = 0
        hl[2], sd[2] = M, W                     # starts past the padding
    yield "random", "adiag", (dirs_a, si, sd, hl)
