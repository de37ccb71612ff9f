# Frozen copy of lamsa_tpu_torch/sim.py (simulate_reads, _mutate, the SV read model) and lamsa_tpu_torch/worlds.py sample_reads (the N rule), vectorized with NumPy.
"""The general read generator every traffic mix is a parameter file of.

The model is ``sim.py``'s: a read is a linear span of the genome on
either strand or, for ``sv_fraction`` of the reads, a span across one
SV (deletion, insertion, inversion, duplication, translocation), and
then the PacBio/ONT-style error model (per base: deletion, else
substitution by a random base, else kept; then a geometric run of
random inserted bases, none after a deleted base). Truth is encoded in
the read name as ``sim.py`` does (``<prefix>_<n>|ref:start-end:strand:
qs-qe;...``, final-read coordinates), so the reference can judge where
each part lands.

What differs from ``sim.py``, and why:
  * the per-base Python loop of ``_mutate`` is vectorized;
  * a span is drawn from the codes, not a decoded string, and is
    redrawn while more than ``max_n_share`` of it is N (the rule of
    ``worlds.sample_reads``, whose 40 kb windows only served to avoid
    decoding 3.1 Gb);
  * every batch holds the same read lengths (evenly spaced over
    ``read_len``) and the same count of each SV kind, in an order the
    seed draws, so that neither the seed nor the number of batches a
    window completes changes how much work a batch holds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SV_KINDS = ("deletion", "insertion", "inversion", "duplication",
            "translocation")
_LUT = np.frombuffer(b"ACGTN", np.uint8)


@dataclasses.dataclass
class Read:
    name: str
    seq: str
    qual: str | None = None


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of nt4 codes (N stays N)."""
    return np.where(codes < 4, 3 - codes, 4).astype(np.uint8)[::-1]


def to_str(codes: np.ndarray) -> str:
    return _LUT[codes].tobytes().decode()


def mutate(rng, codes, sub, ins, dele):
    """sim._mutate on codes: (mutated codes, qmap) where qmap[i] is the
    mutated-read position of perfect-read position i (len + 1
    entries)."""
    n = len(codes)
    r = rng.random(n)
    keep = r >= dele
    sub_mask = keep & (r < dele + sub)
    base = np.where(sub_mask, rng.integers(0, 4, n, dtype=np.uint8), codes)
    nins = np.where(keep, rng.geometric(1.0 - ins, n) - 1, 0) if ins > 0 \
        else np.zeros(n, np.int64)
    emit = keep.astype(np.int64) + nins
    qmap = np.zeros(n + 1, np.int64)
    np.cumsum(emit, out=qmap[1:])
    out = rng.integers(0, 4, int(qmap[-1]), dtype=np.uint8)
    out[qmap[:-1][keep]] = base[keep]
    return out, qmap


class _Spans:
    """Span picker: chromosome weighted by length, start uniform, redrawn
    while more than max_n_share of the span is N."""

    def __init__(self, genome, max_n_share):
        self.g = genome
        lens = np.diff(genome.offsets).astype(np.float64)
        self.p = lens / lens.sum()
        self.max_n = max_n_share

    def pick(self, rng, L):
        g = self.g
        for _ in range(1000):
            ci = int(rng.choice(len(self.p), p=self.p))
            clen = g.chrom_len(ci)
            s = 0 if clen <= L else int(rng.integers(0, clen - L))
            e = min(s + L, clen)
            span = g.codes[g.offsets[ci] + s:g.offsets[ci] + e]
            if (span >= 4).mean() <= self.max_n:
                return ci, s, e
        raise RuntimeError(f"no span of {L} bp with at most "
                           f"{self.max_n:.2%} N found")

    def seq(self, ci, s, e):
        o = int(self.g.offsets[ci])
        return self.g.codes[o + s:o + e]


def _part(g, ci, s, e, strand, qs, qe):
    return [g.names[ci], s, e, strand, qs, qe]


def _linear_read(rng, sp, L):
    ci, s, e = sp.pick(rng, L)
    frag = sp.seq(ci, s, e)
    strand = "+" if rng.random() < 0.5 else "-"
    if strand == "-":
        frag = revcomp(frag)
    return frag, [_part(sp.g, ci, s, e, strand, 0, len(frag))]


def _sv_read(rng, sp, L, kind):
    """sim._simulate_sv_read: the read is two or three parts whose
    reference mappings are discontinuous."""
    g = sp.g
    half = L // 2
    ci, s, _ = sp.pick(rng, L * 3 + 1000)
    seq = lambda a, b: sp.seq(ci, a, b)       # noqa: E731
    if kind == "deletion":
        D = int(rng.integers(50, 2000))
        a, b = seq(s, s + half), seq(s + half + D, s + half + D + half)
        return np.concatenate([a, b]), [
            _part(g, ci, s, s + half, "+", 0, half),
            _part(g, ci, s + half + D, s + half + D + len(b), "+", half,
                  half + len(b))]
    if kind == "insertion":
        ins = int(rng.integers(50, min(1000, max(51, L // 2))))
        novel = rng.integers(0, 4, ins, dtype=np.uint8)
        a, b = seq(s, s + half), seq(s + half, s + L)
        return np.concatenate([a, novel, b]), [
            _part(g, ci, s, s + half, "+", 0, half),
            _part(g, ci, s + half, s + L, "+", half + ins,
                  half + ins + len(b))]
    if kind == "inversion":
        t = L // 3
        a, m, b = seq(s, s + t), revcomp(seq(s + t, s + 2 * t)), \
            seq(s + 2 * t, s + L)
        return np.concatenate([a, m, b]), [
            _part(g, ci, s, s + t, "+", 0, t),
            _part(g, ci, s + t, s + 2 * t, "-", t, 2 * t),
            _part(g, ci, s + 2 * t, s + L, "+", 2 * t, 2 * t + len(b))]
    if kind == "duplication":
        d, b = seq(s, s + half), seq(s + half, s + L)
        return np.concatenate([d, d, b]), [
            _part(g, ci, s, s + half, "+", 0, half),
            _part(g, ci, s, s + half, "+", half, 2 * half),
            _part(g, ci, s + half, s + L, "+", 2 * half, 2 * half + len(b))]
    # translocation: the second half from a locus at least 10 L away or
    # on another chromosome (best effort, as sim.py)
    for _ in range(20):
        cj, s2, _ = sp.pick(rng, L)
        if cj != ci or abs(s2 - s) >= 10 * L:
            break
    a, b = seq(s, s + half), sp.seq(cj, s2, s2 + half)
    return np.concatenate([a, b]), [
        _part(g, ci, s, s + half, "+", 0, half),
        _part(g, cj, s2, s2 + len(b), "+", half, half + len(b))]


def make_pool(genome, traffic: dict, batch: int,
              rng: np.random.Generator, prefix: str = "r") -> list[list]:
    """``pool_batches`` batches of ``batch`` reads of the traffic mix.
    Every batch holds the same read lengths (evenly spaced over
    ``read_len``) and the same count of each SV kind, in an order the
    seed draws."""
    lo, hi = traffic["read_len"]
    lens = lo + np.round((np.arange(batch) + 0.5) / batch
                         * (hi - lo)).astype(np.int64)
    n_sv = int(round(traffic["sv_fraction"] * batch))
    kinds = [SV_KINDS[i % len(SV_KINDS)] for i in range(n_sv)] \
        + [None] * (batch - n_sv)
    sp = _Spans(genome, traffic.get("max_n_share", 0.01))
    sub, ins, dele = traffic["sub"], traffic["ins"], traffic["del"]
    pool, n = [], 0
    for _b in range(int(traffic["pool_batches"])):
        reads = []
        for i in rng.permutation(batch):
            L = int(lens[i])
            if kinds[i] is None:
                perfect, parts = _linear_read(rng, sp, L)
            else:
                perfect, parts = _sv_read(rng, sp, L, kinds[i])
            codes, qmap = mutate(rng, perfect, sub, ins, dele)
            enc = ";".join(f"{r}:{s}-{e}:{st}:{qmap[qs]}-{qmap[qe]}"
                           for r, s, e, st, qs, qe in parts)
            reads.append(Read(name=f"{prefix}_{n}|{enc}",
                              seq=to_str(codes)))
            n += 1
        pool.append(reads)
    return pool
