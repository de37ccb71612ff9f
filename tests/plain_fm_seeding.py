"""A plain reference of FM seeding, in plain PyTorch: the seed hits
``lamsa_tpu_torch.pipeline.seeding.seed_hits_fm`` has to return, found
by comparing each seed piece with every window of the genome.

It imports no index, kernel or seeding code of either package, and no
JAX. The semantics it states:

  a piece      the k read bases at a position of the sample grid, fully
               inside the read and free of N; on strand 1 the piece's
               reverse complement, placed at read_len - qpos - k in the
               reverse-complemented read
  a hit        (strand, qpos, rpos): a genome window of the piece's
               length at rpos (global coordinates, chromosomes end to
               end) equal to the piece; a genome N never matches
  1-edit hits  with ``sub1_k``, the windows at Hamming distance exactly
               1 from each sub1_k-long piece: the occurrences of its
               single-substitution variants

Every hit is returned, with no candidate cap and no cut to a budget:
a test holds seed_hits_fm to it where the occurrence counts lie under
the caps (the stats it returns give the largest).
"""

from __future__ import annotations

import torch

_CHUNK = 64                      # pieces compared with the genome at once


def _revcomp(codes: torch.Tensor) -> torch.Tensor:
    return torch.where(codes < 4, 3 - codes, codes).flip(-1)


def _pieces(read, read_len, grid, k):
    """[(qpos, piece)] of one read's valid k-long grid windows."""
    out = []
    for qp in grid.tolist():
        if qp + k <= read_len:
            piece = read[qp:qp + k]
            if bool((piece < 4).all()):
                out.append((qp, piece))
    return out


def _matches(genome, pieces, k, mismatches):
    """For each piece, the window starts at Hamming distance exactly
    ``mismatches`` and, for each of those, the offset and genome base of
    its mismatch (-1, -1 for an exact match)."""
    win = genome.unfold(0, k, 1)                           # (n - k + 1, k)
    clean = (win < 4).all(dim=1)
    out = []
    for c0 in range(0, len(pieces), _CHUNK):
        chunk = torch.stack(pieces[c0:c0 + _CHUNK])        # (m, k)
        diff = win[None, :, :] != chunk[:, None, :]        # (m, n', k)
        hit = (diff.sum(dim=2) == mismatches) & clean[None, :]
        for i in range(chunk.shape[0]):
            starts = torch.nonzero(hit[i]).flatten()
            if mismatches:
                off = diff[i, starts].to(torch.int64).argmax(dim=1)
                base = win[starts, off].to(torch.int64)
            else:
                off = base = torch.full_like(starts, -1)
            out.append((starts, off, base))
    return out


def plain_seed_hits(genome, reads, read_lens, grid, k, sub1_k=0):
    """Per read, the sorted list of (strand, qpos, rpos) hits of its k
    pieces and, with ``sub1_k``, of its sub1_k pieces' 1-substitution
    variants, both strands; and a dict with the largest number of
    occurrences of one piece (``exact``) and of one variant (``1edit``),
    to hold under the caps, and the number of variant hits
    (``1edit_hits``)."""
    genome = torch.as_tensor(genome).to(torch.uint8)
    reads = torch.as_tensor(reads).to(torch.uint8)
    grid = torch.as_tensor(grid).to(torch.int64)
    hits = [[] for _ in range(reads.shape[0])]
    stats = {"exact": 0, "1edit": 0, "1edit_hits": 0}
    jobs = [(k, 0, "exact")] + ([(sub1_k, 1, "1edit")] if sub1_k else [])
    for b in range(reads.shape[0]):
        n = int(read_lens[b])
        for kk, mism, kind in jobs:
            found = _pieces(reads[b], n, grid, kk)
            for strand in (0, 1):
                pieces = [p if strand == 0 else _revcomp(p)
                          for _qp, p in found]
                for (qp, _p), (starts, off, base) in zip(
                        found, _matches(genome, pieces, kk, mism)):
                    q = qp if strand == 0 else n - qp - kk
                    hits[b] += [(strand, q, int(r)) for r in starts]
                    if mism:
                        stats["1edit_hits"] += len(starts)
                    if len(starts):
                        # one variant = one (mismatch offset, base)
                        _u, cnt = torch.unique(off * 4 + base,
                                               return_counts=True)
                        stats[kind] = max(stats[kind], int(cnt.max()))
        hits[b].sort()
    return hits, stats
