"""The port's FM seeding (``seed_hits_fm``) against a plain reference that
compares every seed piece with every genome window
(tests/plain_fm_seeding.py), on the CPU: a seeded genome of two
chromosomes with N runs and a repeated segment, reads from both strands
with substitutions and an N run. Where the caps cannot decide (every
piece and every variant occurs at most the candidates kept per seed,
and no read reaches its hit budget), the hit sets are equal: exact
pieces, and with the 1-edit tracks their single-substitution variants,
at the search length and longer. Imports no JAX."""

import numpy as np
import pytest
import torch

from lamsa_tpu_torch.index.fmindex import FmIndex
from lamsa_tpu_torch.ops.fm import fm_device_state
from lamsa_tpu_torch.pipeline.seeding import make_qpos_grid, seed_hits_fm
from plain_fm_seeding import plain_seed_hits

torch.set_num_threads(1)

K, C, C1, MAX_HITS = 12, 8, 4, 4096


@pytest.fixture(scope="module", params=[4, 16], ids=["sa4", "sa16"])
def world(request):
    """Two chromosomes of 24 kb, each with 3 N runs of 60-400 bp; a 300
    bp segment of chromosome 1 copied twice into chromosome 2 (pieces
    with three occurrences); 8 reads of 250-400 bp, half reverse
    complemented, 3% substitutions, one across an N run's edge."""
    rng = np.random.default_rng(20261021)
    chroms = []
    for _ in range(2):
        c = rng.integers(0, 4, 24_000).astype(np.uint8)
        for s in rng.choice(np.arange(500, 23_000, 1000), 3, replace=False):
            c[s:s + int(rng.integers(60, 400))] = 4
        chroms.append(c)
    seg = chroms[0][2_050:2_350].copy()
    chroms[1][5_000:5_300] = seg
    chroms[1][15_020:15_320] = seg
    genome = np.concatenate(chroms)
    idx = FmIndex.build(genome, sa_rate=request.param)

    n_runs = np.flatnonzero(np.diff((genome >= 4).astype(np.int8)) == 1)
    starts = [2_000, 9_000, 21_000, 27_000, 33_000, 40_000, 45_000,
              int(n_runs[0]) - 150]
    lens = rng.integers(250, 401, len(starts))
    reads = np.full((len(starts), 512), 4, np.int64)
    for b, (s, n) in enumerate(zip(starts, lens)):
        frag = genome[s:s + n].astype(np.int64)
        sub = rng.random(n) < 0.03
        frag[sub] = np.where(frag[sub] < 4,
                             (frag[sub] + rng.integers(1, 4, sub.sum())) % 4,
                             frag[sub])
        if b % 2:
            frag = np.where(frag < 4, 3 - frag, 4)[::-1]
        reads[b, :n] = frag
    assert (reads[-1] == 4).sum() > 512 - lens[-1]      # the N run
    return genome, fm_device_state(idx, "cpu"), idx.sa_rate, reads, lens


def _port_hits(out):
    hits = []
    for b in range(out["valid"].shape[0]):
        v = out["valid"][b]
        hits.append(sorted(zip(out["strand"][b][v].tolist(),
                               out["qpos"][b][v].tolist(),
                               out["rpos"][b][v].tolist())))
    return hits


@pytest.mark.parametrize("sub1_k", [0, K, K + 2],
                         ids=["exact", "1edit", "1edit_longer"])
def test_seed_hits_fm_equals_the_plain_reference(world, sub1_k):
    genome, st, sa_rate, reads, lens = world
    grid = make_qpos_grid(512, K, 7)
    want, stats = plain_seed_hits(genome, reads, lens, grid, K,
                                  sub1_k=sub1_k)
    # the caps do not decide
    assert stats["exact"] <= C and stats["1edit"] <= C1
    assert max(len(h) for h in want) < MAX_HITS
    out = seed_hits_fm(torch.from_numpy(reads), torch.from_numpy(lens),
                       torch.from_numpy(grid.astype(np.int64)), st, k=K,
                       cands_per_seed=C, max_hits=MAX_HITS, sa_rate=sa_rate,
                       sub1_cands=C1 if sub1_k else 0, sub1_k=sub1_k)
    assert _port_hits(out) == want
    # what the world exercises: both strands, repeats, and variants
    flat = [h for hs in want for h in hs]
    assert {s for s, _q, _r in flat} == {0, 1}
    assert stats["exact"] >= 3
    assert (stats["1edit_hits"] > 0) == bool(sub1_k)
