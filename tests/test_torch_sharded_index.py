"""Key-range sharded k-mer seeding (lamsa_tpu_torch/parallel/
sharded_index.py) on CPU entries: hits and chains bit-identical to the
replicated seed_hits (tests/test_sharded_index.py's cases), per-entry
position bytes about 1/D of the index, a k = 16 genome whose all-T key
equals the padding key, and keys with more occurrences than candidates
per seed (the window rotation must survive the split)."""

import numpy as np
import pytest
import torch

from lamsa_tpu_torch import sim
from lamsa_tpu_torch.config import AlignConfig
from lamsa_tpu_torch.index.kmer import KmerIndex
from lamsa_tpu_torch.io.fasta import encode_seq
from lamsa_tpu_torch.parallel.mesh import make_mesh, shard_batch
from lamsa_tpu_torch.parallel.sharded_index import (
    _PAD_KEY, place_sharded, seed_chain_step_sharded, seed_hits_sharded,
    shard_kmer_index)
from lamsa_tpu_torch.pipeline.seeding import make_qpos_grid, seed_hits
from lamsa_tpu_torch.parallel.mesh import seed_chain_step

torch.set_num_threads(1)


def _world(rng, genome_len=30000, B=16, L=512, k=13, seq=None):
    cfg = AlignConfig(seed_step=10)
    genome = [sim.FastxRecord(name="chr1", seq=seq)] if seq is not None \
        else sim.random_genome(rng, genome_len)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    idx = KmerIndex.build(codes, k)
    reads = sim.simulate_reads(rng, genome, B, read_len=(L // 2, L - 8),
                               sub=0.02, ins=0.03, dele=0.03)
    rc = np.full((B, L), 4, np.int64)
    rl = np.zeros(B, np.int64)
    for i, r in enumerate(reads):
        c = np.frombuffer(encode_seq(r.seq), np.uint8)[:L]
        rc[i, :len(c)] = c
        rl[i] = len(c)
    grid = make_qpos_grid(L, idx.k, cfg.seed_step).astype(np.int64)
    return cfg, idx, rc, rl, grid


def _replicated(cfg, idx, rc, rl, grid):
    t = torch.from_numpy
    return seed_hits(t(rc), t(rl), t(grid), t(idx.keys.astype(np.int64)),
                     t(idx.starts.astype(np.int32)),
                     t(idx.counts.astype(np.int32)),
                     t(idx.positions.astype(np.int64)), k=idx.k,
                     cands_per_seed=cfg.max_cands_per_seed,
                     max_hits=cfg.max_hits_per_read)


def _sharded(cfg, idx, rc, rl, grid, D):
    mesh = make_mesh(["cpu"] * D)
    sh = place_sharded(mesh, shard_kmer_index(idx, D))
    rc_d, rl_d = shard_batch(mesh, rc, rl)
    parts = seed_hits_sharded(rc_d, rl_d, grid, sh["keys"], sh["starts"],
                              sh["counts"], sh["positions"], mesh=mesh,
                              k=idx.k, cands_per_seed=cfg.max_cands_per_seed,
                              max_hits=cfg.max_hits_per_read)
    return {n: torch.cat([p[n] for p in parts]) for n in parts[0]}


def _assert_same(got, want):
    for name in ("qpos", "rpos", "strand", "valid"):
        assert torch.equal(got[name], want[name]), name
    assert want["valid"].any()


def test_shard_kmer_index_partitions(rng):
    _, idx, _, _, _ = _world(rng)
    D = 8
    sh = shard_kmer_index(idx, D)
    assert sh["keys"].shape[0] == D
    seen = 0
    for d in range(D):
        real = sh["counts"][d] > 0
        for i in np.nonzero(real)[0][:20]:
            s, c = sh["starts"][d, i], sh["counts"][d, i]
            got = sh["positions"][d, s:s + c].astype(np.int64)
            assert np.array_equal(got, idx.lookup_host(int(sh["keys"][d, i])))
        seen += int(real.sum())
    assert seen == len(idx.keys)


@pytest.mark.parametrize("D", [2, 3, 8])
def test_sharded_seeding_matches_replicated(rng, D):
    cfg, idx, rc, rl, grid = _world(rng)
    _assert_same(_sharded(cfg, idx, rc, rl, grid, D),
                 _replicated(cfg, idx, rc, rl, grid))


def test_sharded_seed_chain_step(rng):
    cfg, idx, rc, rl, grid = _world(rng, B=8, L=256)
    mesh = make_mesh(["cpu"] * 4)
    kw = dict(k=idx.k, cands_per_seed=cfg.max_cands_per_seed,
              max_hits=cfg.max_hits_per_read, weight=idx.k,
              lookback=cfg.chain_lookback, max_dist=cfg.chain_max_dist,
              diag_slack=cfg.chain_diag_slack)
    t = torch.from_numpy
    want = seed_chain_step(t(rc), t(rl), t(grid),
                           t(idx.keys.astype(np.int64)), t(idx.starts),
                           t(idx.counts), t(idx.positions.astype(np.int64)),
                           **kw)
    sh = place_sharded(mesh, shard_kmer_index(idx, 4))
    rc_d, rl_d = shard_batch(mesh, rc, rl)
    parts = seed_chain_step_sharded(rc_d, rl_d, grid, sh["keys"],
                                    sh["starts"], sh["counts"],
                                    sh["positions"], mesh=mesh, **kw)
    for name in ("f", "pred"):
        assert torch.equal(torch.cat([p[name] for p in parts]), want[name])


def test_sharded_index_memory_drops(rng):
    """Per-entry index bytes fall by about the entry count."""
    _, idx, _, _, _ = _world(rng)
    D = 8
    mesh = make_mesh(["cpu"] * D)
    sh = place_sharded(mesh, shard_kmer_index(idx, D))
    total = len(idx.positions)
    assert sh["positions"][0].shape[0] <= total // D + total // (2 * D) + 64
    whole = 8 * (len(idx.keys) + len(idx.positions)) + 8 * len(idx.keys)
    per = sum(sh[n][0].nbytes for n in ("keys", "starts", "counts",
                                        "positions"))
    assert per * D <= 1.2 * whole


def test_k16_all_t_key_equals_the_padding_key(rng):
    """At k = 16 the all-T key is 0xFFFFFFFF, the padding key. The last
    shard holds it, followed by padding rows of the same key and count
    0: the binary search finds the real row first. Hits equal the
    replicated path's, the all-T seeds included."""
    g = sim.random_genome(np.random.default_rng(5), 20000)[0].seq
    seq = g[:9000] + "T" * 40 + g[9000:]
    cfg, idx, rc, rl, grid = _world(rng, B=12, L=512, k=16, seq=seq)
    assert int(idx.keys[-1]) == int(_PAD_KEY)       # all-T is indexed
    # one read covering the run, on the forward strand
    c = np.frombuffer(encode_seq(seq[8900:9300]), np.uint8)
    rc[0] = 4
    rc[0, :len(c)] = c
    rl[0] = len(c)
    want = _replicated(cfg, idx, rc, rl, grid)
    for D in [D for D in range(3, 12) if len(idx.keys) % D][:2]:
        sh = shard_kmer_index(idx, D)
        assert (sh["keys"][-1] == _PAD_KEY).sum() > 1   # padding rows
        _assert_same(_sharded(cfg, idx, rc, rl, grid, D), want)
    run = [(q, r) for q, r, v, s in zip(
        want["qpos"][0].tolist(), want["rpos"][0].tolist(),
        want["valid"][0].tolist(), want["strand"][0].tolist())
        if v and s == 0 and 100 <= q <= 124]
    assert run                                      # all-T seeds hit


def test_rotation_kept_for_frequent_keys(rng):
    """A genome of repeats: keys with more occurrences than candidates
    per seed take a per-window rotated slice of their positions; the
    sharded lookup keeps it."""
    unit = sim.random_genome(np.random.default_rng(6), 700)[0].seq
    seq = unit * 40 + sim.random_genome(np.random.default_rng(7),
                                        8000)[0].seq
    cfg, idx, rc, rl, grid = _world(rng, seq=seq)
    assert int(idx.counts.max()) > cfg.max_cands_per_seed
    _assert_same(_sharded(cfg, idx, rc, rl, grid, 4),
                 _replicated(cfg, idx, rc, rl, grid))
