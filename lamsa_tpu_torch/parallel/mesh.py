"""Data parallelism over reads, on a list of torch devices.

Counterpart of ``lamsa_tpu/parallel/mesh.py``. The JAX package shards
the batch dimension of every device stage over a ``jax.sharding.Mesh``
with one axis. Here a mesh is an ordered tuple of torch devices, one
entry per share of the batch. Entry d takes the d-th contiguous block of
rows (``row_blocks``: the layout of ``P(DATA_AXIS)`` over a batch padded
to a multiple of the entry count). An entry may repeat a device: two
entries on one card hold one copy of the index and reference
(``replicate`` copies once per distinct device) and run their DP chunks
on two streams. Seeding, chaining and the banded DP work row by row, so
no stage exchanges data between entries and the joined results equal a
one-device run.
"""

from __future__ import annotations

import numpy as np
import torch

from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row
from lamsa_tpu_torch.ops.chain import chain_hits
from lamsa_tpu_torch.ops.wire import extract_scores
from lamsa_tpu_torch.pipeline.seeding import seed_hits


def norm_device(dev) -> torch.device:
    """A device with its index: "cuda" is card 0, so that repeated
    entries compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def make_mesh(devices) -> tuple[torch.device, ...]:
    """The ordered device entries of a mesh. Entries may repeat."""
    mesh = tuple(norm_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def distinct(mesh) -> list[torch.device]:
    """The mesh's devices, each once, in order of first entry."""
    return list(dict.fromkeys(mesh))


def row_blocks(n: int, size: int) -> list[tuple[int, int]]:
    """Contiguous [lo, hi) row ranges, one per entry: ceil(n / size)
    rows each, the last entries shorter or empty."""
    s = -(-n // size)
    return [(min(d * s, n), min(d * s + s, n)) for d in range(size)]


def _tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def shard_batch(mesh, *arrays):
    """Per array, a tuple with each entry's block of its leading (read or
    instance) dim, on the entry's device."""
    out = []
    for a in arrays:
        t = _tensor(a)
        out.append(tuple(t[lo:hi].to(dev) for dev, (lo, hi)
                         in zip(mesh, row_blocks(t.shape[0], len(mesh)))))
    return tuple(out)


def replicate(mesh, *arrays):
    """Per array, a tuple with its copy for each entry: one copy per
    distinct device, shared by the entries that repeat it."""
    out = []
    for a in arrays:
        t = _tensor(a)
        copies = {dev: t.to(dev) for dev in distinct(mesh)}
        out.append(tuple(copies[dev] for dev in mesh))
    return tuple(out)


def join(parts: list[dict], dev) -> dict:
    """Per-entry result dicts (rows in entry order) -> one dict on dev."""
    return {k: torch.cat([p[k].to(dev) for p in parts]) for k in parts[0]}


def seed_chain_step(read_codes, read_len, qpos_grid, idx_keys, idx_starts,
                    idx_counts, idx_positions, *, k, cands_per_seed,
                    max_hits, weight, lookback, max_dist, diag_slack):
    """Seeding + chaining of one batch on one device (keys and positions
    int64, as pipeline/state.py keeps them)."""
    hits = seed_hits(read_codes, read_len, qpos_grid, idx_keys, idx_starts,
                     idx_counts, idx_positions, k=k,
                     cands_per_seed=cands_per_seed, max_hits=max_hits)
    f, pred = chain_hits(hits["qpos"], hits["rpos"], hits["strand"],
                         hits["valid"], weight=weight, lookback=lookback,
                         max_dist=max_dist, diag_slack=diag_slack)
    return {**hits, "f": f, "pred": pred}


def banded_dp_step(q, t_win, m_len, n_len, lo, *, match, mismatch, gapo,
                   gape):
    """Banded-DP scoring of one instance batch on one device: the row DP
    kernel with zdrop off, then the global and to-end scores."""
    res = banded_sw_row(q, t_win, m_len, n_len, lo, torch.zeros_like(m_len),
                        match=match, mismatch=mismatch, gapo=gapo, gape=gape)
    g, te, te_d = extract_scores(res["h_last"], m_len, n_len, lo)
    return {"global_score": g, "te_score": te, "te_d": te_d,
            "best": res["best"]}


def full_align_step(mesh, batch: dict, index: dict, dp: dict, config,
                    shard_index: bool = False) -> dict:
    """Seed -> chain -> banded-DP scoring with the rows of ``batch`` and
    ``dp`` split over the mesh. ``index`` (host arrays: k, grid, keys,
    starts, counts, positions) is replicated per device or, with
    shard_index, split into per-entry key ranges
    (parallel/sharded_index.py). Results are joined in row order on the
    first entry's device."""
    rc, rl = shard_batch(mesh, batch["codes"], batch["len"])
    chain_kw = dict(
        k=index["k"], cands_per_seed=config.max_cands_per_seed,
        max_hits=config.max_hits_per_read, weight=index["k"],
        lookback=config.chain_lookback, max_dist=config.chain_max_dist,
        diag_slack=config.chain_diag_slack)
    grid = np.asarray(index["grid"], np.int64)
    if shard_index:
        from lamsa_tpu_torch.index.kmer import KmerIndex
        from lamsa_tpu_torch.parallel.sharded_index import (
            place_sharded, seed_chain_step_sharded, shard_kmer_index)
        kidx = KmerIndex(k=index["k"], keys=np.asarray(index["keys"]),
                         starts=np.asarray(index["starts"]),
                         counts=np.asarray(index["counts"]),
                         positions=np.asarray(index["positions"]))
        sh = place_sharded(mesh, shard_kmer_index(kidx, len(mesh)))
        parts = seed_chain_step_sharded(
            rc, rl, grid, sh["keys"], sh["starts"], sh["counts"],
            sh["positions"], mesh=mesh, **chain_kw)
    else:
        keys, starts, counts, positions = replicate(
            mesh, np.asarray(index["keys"], np.int64),
            np.asarray(index["starts"], np.int32),
            np.asarray(index["counts"], np.int32),
            np.asarray(index["positions"], np.int64))
        (grids,) = replicate(mesh, grid)
        parts = [seed_chain_step(rc[d], rl[d], grids[d], keys[d], starts[d],
                                 counts[d], positions[d], **chain_kw)
                 for d in range(len(mesh))]
    i32 = [np.asarray(dp[n], np.int32)
           for n in ("q", "t_win", "m_len", "n_len", "lo")]
    q, t_win, m_len, n_len, lo = shard_batch(mesh, *i32)
    s = config.scores
    dpr = [banded_dp_step(q[d], t_win[d], m_len[d], n_len[d], lo[d],
                          match=s.match, mismatch=s.mismatch,
                          gapo=s.gap_open, gape=s.gap_ext)
           for d in range(len(mesh))]
    return {"chain": join(parts, mesh[0]), "dp": join(dpr, mesh[0])}
