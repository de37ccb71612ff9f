"""Sharded-index seeding: the k-mer table split into key ranges over a
mesh's entries, candidate blocks summed back to each read's own entry.

Counterpart of ``lamsa_tpu/parallel/sharded_index.py``. The replicated
mode (parallel/mesh.py) keeps a whole index per device; for indexes
past one card's memory, ``shard_kmer_index`` (a copy of the JAX
package's, numpy) splits the sorted table into contiguous key ranges,
one per entry, each with exactly its slice of the positions. Seeding
then takes the JAX package's collectives as device-to-device copies in
one process:

  * all-gather: every entry gets every entry's read rows;
  * each entry looks the whole batch's windows up in its own key range
    (``extract_windows``, ``window_keys``, ``table_lookup``); a key lives
    in one range only, so the entries' candidate blocks are disjoint;
  * reduce-scatter: each read's own entry sums the blocks' rows of its
    reads (positions where found, else 0, and the found flags) and
    packs its hits (``pack_hits``).

Unlike the JAX package's sharded lookup, each window keeps its candidate
rotation (``seed_rotation``), so the result is bit-identical to
``pipeline/seeding.py`` ``seed_hits`` also for keys with more
occurrences than candidates per seed.
"""

from __future__ import annotations

import numpy as np
import torch

from lamsa_tpu_torch.ops.chain import chain_hits
from lamsa_tpu_torch.parallel.mesh import distinct, replicate
from lamsa_tpu_torch.pipeline.seeding import (extract_windows, pack_hits,
                                              seed_rotation, table_lookup,
                                              window_keys)

# ---- copied verbatim from lamsa_tpu/parallel/sharded_index.py

# Sentinel for key padding: >= every real 2-bit-packed key. For k=16 the
# all-T key equals the sentinel; padded rows carry count 0, so a probe
# that lands on one yields zero candidates rather than a false hit.
_PAD_KEY = np.uint32(0xFFFFFFFF)


def shard_kmer_index(index, n_shards: int) -> dict:
    """Split a KmerIndex into n_shards contiguous key ranges.

    Returns host arrays stacked on a leading shard dim, equal-shaped per
    shard (padded with sentinel keys / zero counts / zero positions):
      keys uint32[D, Ks], starts int32[D, Ks], counts int32[D, Ks],
      positions uint32[D, Ps], plus {"k": index.k}.
    """
    U = len(index.keys)
    D = n_shards
    Ks = max(1, -(-U // D))
    bounds = [min(U, d * Ks) for d in range(D + 1)]
    pos_slices = []
    for d in range(D):
        k0, k1 = bounds[d], bounds[d + 1]
        if k0 >= k1:
            pos_slices.append((0, 0))
            continue
        p0 = int(index.starts[k0])
        p1 = int(index.starts[k1 - 1] + index.counts[k1 - 1])
        pos_slices.append((p0, p1))
    Ps = max(1, max(p1 - p0 for p0, p1 in pos_slices))

    keys = np.full((D, Ks), _PAD_KEY, np.uint32)
    starts = np.zeros((D, Ks), np.int32)
    counts = np.zeros((D, Ks), np.int32)
    positions = np.zeros((D, Ps), np.uint32)
    for d in range(D):
        k0, k1 = bounds[d], bounds[d + 1]
        if k0 >= k1:
            continue
        p0, p1 = pos_slices[d]
        n = k1 - k0
        keys[d, :n] = index.keys[k0:k1]
        starts[d, :n] = index.starts[k0:k1] - p0
        counts[d, :n] = index.counts[k0:k1]
        positions[d, :p1 - p0] = index.positions[p0:p1].astype(np.uint32)
    return {"k": index.k, "keys": keys, "starts": starts,
            "counts": counts, "positions": positions}


# ---- end of the copy


def place_sharded(mesh, sharded: dict) -> dict:
    """Shard d of each table on entry d, with the dtypes of
    pipeline/state.py (keys and positions int64, starts and counts
    int32). Returns {"k", name: tuple of per-entry tensors}."""
    D = sharded["keys"].shape[0]
    if D != len(mesh):
        raise ValueError(f"{D} index shards for a mesh of {len(mesh)}")
    dtypes = {"keys": np.int64, "starts": np.int32, "counts": np.int32,
              "positions": np.int64}
    out = {"k": sharded["k"]}
    for name, dt in dtypes.items():
        out[name] = tuple(
            torch.from_numpy(sharded[name][d].astype(dt)).to(mesh[d])
            for d in range(D))
    return out


def seed_hits_sharded(read_codes, read_len, qpos_grid, keys, starts, counts,
                      positions, *, mesh, k, cands_per_seed, max_hits):
    """seed_hits against a key-range-sharded index.

    read_codes / read_len: per-entry row blocks (parallel/mesh.py
    shard_batch); keys / starts / counts / positions: per-entry shards
    (place_sharded); qpos_grid: the sample grid, copied to each device.
    Returns per entry the seed_hits dict of its own rows, bit-identical
    to seed_hits on the whole batch."""
    (grid,) = replicate(mesh, qpos_grid)
    sizes = [int(r.shape[0]) for r in read_codes]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    gathered = {}                       # all rows, once per device
    for dev in distinct(mesh):
        gathered[dev] = (torch.cat([r.to(dev) for r in read_codes]),
                         torch.cat([r.to(dev) for r in read_len]))
    blocks = []                         # per shard: (4, B, S, C) int64
    for d, dev in enumerate(mesh):
        rc_all, rl_all = gathered[dev]
        win, win_ok = extract_windows(rc_all, rl_all, grid[d], k)
        key_f, key_r = window_keys(win, k)
        rot = seed_rotation(grid[d])
        tab = (keys[d], starts[d], counts[d], positions[d], cands_per_seed)
        pos_f, ok_f = table_lookup(key_f, *tab, rot)
        pos_r, ok_r = table_lookup(key_r, *tab, rot)
        blocks.append(torch.stack([
            torch.where(ok_f, pos_f, 0), torch.where(ok_r, pos_r, 0),
            ok_f.to(torch.int64), ok_r.to(torch.int64)]))
    out = []
    for e, dev in enumerate(mesh):
        lo, hi = int(offs[e]), int(offs[e + 1])
        tot = sum(b[:, lo:hi].to(dev) for b in blocks)
        _, win_ok = extract_windows(read_codes[e], read_len[e], grid[e], k)
        out.append(pack_hits(grid[e], read_len[e], tot[0], tot[2] > 0,
                             tot[1], tot[3] > 0, win_ok, k=k,
                             max_hits=max_hits))
    return out


def seed_chain_step_sharded(read_codes, read_len, qpos_grid, keys, starts,
                            counts, positions, *, mesh, k, cands_per_seed,
                            max_hits, weight, lookback, max_dist,
                            diag_slack):
    """seed_hits_sharded, then chaining on each read's own entry (the
    sharded twin of parallel/mesh.py seed_chain_step). Returns the
    per-entry dicts."""
    out = []
    for hits in seed_hits_sharded(read_codes, read_len, qpos_grid, keys,
                                  starts, counts, positions, mesh=mesh, k=k,
                                  cands_per_seed=cands_per_seed,
                                  max_hits=max_hits):
        f, pred = chain_hits(hits["qpos"], hits["rpos"], hits["strand"],
                             hits["valid"], weight=weight,
                             lookback=lookback, max_dist=max_dist,
                             diag_slack=diag_slack)
        out.append({**hits, "f": f, "pred": pred})
    return out
