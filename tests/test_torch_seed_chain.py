"""Seeding and chaining of the PyTorch port against the JAX package:
seed_hits (sorted table, torch.searchsorted) against JAX seed_hits on a
repeat-family world where the per-window candidate rotation fires,
table_lookup at the search's edges, and chain_hits against JAX
chain_hits with deliberate ties and uint32 wraparound. Exact
equality."""

import numpy as np
import pytest
import torch

from lamsa_tpu import sim
from lamsa_tpu.index.kmer import KmerIndex
from lamsa_tpu.io.fasta import encode_seq
from lamsa_tpu.ops.chain import chain_hits as jax_chain_hits
from lamsa_tpu.pipeline.seeding import make_qpos_grid, seed_hits as jax_seed
from lamsa_tpu.pipeline.seeding import seed_rotation as jax_rotation
from lamsa_tpu.pipeline.seeding import table_lookup as jax_lookup
from lamsa_tpu_torch.index.kmer import KmerIndex as PortKmerIndex
from lamsa_tpu_torch.ops.chain import chain_hits
from lamsa_tpu_torch.pipeline import seeding
from lamsa_tpu_torch.pipeline.state import device_state

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def repeat_world():
    rng = np.random.default_rng(20260821)
    genome = sim.repeat_genome(rng, 200_000)
    codes = np.frombuffer(encode_seq(genome[0].seq), np.uint8)
    reads = sim.simulate_reads(np.random.default_rng(3), genome, 12,
                               read_len=(300, 1000), sub=0.02, ins=0.03,
                               dele=0.03)
    return codes, reads


@pytest.mark.parametrize("k,step,C", [(11, 7, 8), (12, 10, 4)])
def test_seed_hits_match_jax(repeat_world, k, step, C):
    codes, reads = repeat_world
    idx = KmerIndex.build(codes, k)
    L, H = 1024, 256
    B = len(reads)
    rc = np.full((B, L), 4, np.int32)
    rl = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        c = np.frombuffer(encode_seq(r.seq), np.uint8)[:L]
        rc[i, :len(c)] = c
        rl[i] = len(c)
    grid = make_qpos_grid(L, k, step)
    common = dict(k=k, cands_per_seed=C, max_hits=H)
    want = jax_seed(rc, rl, grid, idx.keys, idx.starts, idx.counts,
                    idx.positions.astype(np.uint32), **common)
    want = {n: np.asarray(v).astype(np.int64) for n, v in want.items()}
    assert want["valid"].any()

    class _Ref:
        pass
    ref = _Ref()
    ref.codes = codes
    st = device_state(ref, PortKmerIndex.build(codes, k), "cpu")
    args = (torch.from_numpy(rc), torch.from_numpy(rl),
            torch.from_numpy(grid.astype(np.int64)))
    got = seeding.seed_hits(*args, st["keys"], st["starts"], st["counts"],
                            st["positions"], **common)
    for name in ("qpos", "rpos", "strand", "valid"):
        np.testing.assert_array_equal(got[name].numpy().astype(np.int64),
                                      want[name], err_msg=name)

    # the rotation fired: some seeded key has more than C occurrences
    kf, kr = seeding.window_keys(
        seeding.extract_windows(args[0], args[1], args[2], k)[0], k)
    keys = torch.cat([kf, kr]).flatten()
    pos = torch.searchsorted(st["keys"], keys).clamp(max=len(idx.keys) - 1)
    hit = st["keys"][pos] == keys
    assert (st["counts"][pos][hit] > C).any()


def test_table_lookup_edges_match_jax():
    """Keys below the smallest and above the largest indexed key, absent
    keys between them, and keys with more than C occurrences (rotated
    slices), against JAX table_lookup."""
    rng = np.random.default_rng(13)
    k, C = 9, 4
    unit = rng.integers(0, 4, 40).astype(np.uint8)
    codes = np.concatenate([np.tile(unit, 30),
                            rng.integers(0, 4, 6000).astype(np.uint8)])
    idx = KmerIndex.build(codes, k)
    present = idx.keys[rng.integers(0, len(idx.keys), 40)]
    absent = np.setdiff1d(rng.integers(0, 4 ** k, 400), idx.keys)[:40]
    edges = [0, int(idx.keys[0]), int(idx.keys[-1]), 4 ** k - 1,
             int(idx.keys[np.argmax(idx.counts)])]
    keys = np.concatenate([present, absent, edges]).astype(np.int64)
    S = 16
    keys = np.resize(keys, (len(keys) // S + 1) * S).reshape(-1, S)
    grid = np.arange(S, dtype=np.int32) * 7
    assert (idx.counts > C).any()
    want_pos, want_ok = jax_lookup(keys.astype(np.uint32), idx.keys,
                                   idx.starts, idx.counts,
                                   idx.positions.astype(np.uint32), C,
                                   jax_rotation(grid))
    st = device_state(type("R", (), {"codes": codes})(),
                      PortKmerIndex.build(codes, k), "cpu")
    pos, ok = seeding.table_lookup(
        torch.from_numpy(keys), st["keys"], st["starts"], st["counts"],
        st["positions"], C, seeding.seed_rotation(torch.from_numpy(grid)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(pos.numpy(),
                                  np.asarray(want_pos).astype(np.int64))
    assert ok.numpy().any() and not ok.numpy().all()


def _chain_rows(rng, B, H):
    """Sorted hit rows with exact duplicates and mirror-image
    predecessors (equal candidate scores -> the first max must win), and
    one row whose rpos straddles the uint32 wrap."""
    qs, rs, ss, vs = [], [], [], []
    for b in range(B):
        rows = []
        r0 = int(rng.integers(0, 100000)) if b != 1 else 2**32 - 600
        for t in range(H // 4):
            q, r = 20 * t, r0 + 20 * t + int(rng.integers(-2, 3))
            rows.append((0, q, r % 2**32))
            rows.append((0, q, r % 2**32))               # duplicate
            rows.append((0, q, (r + 2) % 2**32))         # mirror pair
        while len(rows) < H:
            rows.append((int(rng.integers(0, 2)), int(rng.integers(0, 2000)),
                         int(rng.integers(0, 2**32))))
        rows.sort()
        rows = rows[:H]
        ss.append([x[0] for x in rows])
        qs.append([x[1] for x in rows])
        rs.append([x[2] for x in rows])
        v = np.ones(H, bool)
        v[rng.integers(0, H, H // 10)] = False
        vs.append(v)
    return (np.asarray(qs, np.int32), np.asarray(rs, np.uint32),
            np.asarray(ss, np.int32), np.stack(vs))


def test_chain_hits_match_jax(rng):
    B, H = 4, 128
    qpos, rpos, strand, valid = _chain_rows(rng, B, H)
    kw = dict(weight=13, lookback=32, max_dist=5000, diag_slack=100)
    wf, wp = jax_chain_hits(qpos, rpos, strand, valid, **kw)
    f, pred = chain_hits(torch.from_numpy(qpos),
                         torch.from_numpy(rpos.astype(np.int64)),
                         torch.from_numpy(strand), torch.from_numpy(valid),
                         **kw)
    np.testing.assert_array_equal(f.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(wp))
    # ties really occurred: a hit whose predecessor has an identical twin
    p = pred.numpy()
    twin = False
    for b in range(B):
        for kk in np.flatnonzero(p[b] >= 0):
            l = p[b, kk]
            twin |= l + 1 < kk and qpos[b, l] == qpos[b, l + 1] \
                and rpos[b, l] == rpos[b, l + 1] and valid[b, l + 1]
    assert twin
