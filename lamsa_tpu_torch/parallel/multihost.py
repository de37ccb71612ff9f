"""Several processes: batch ownership and the ordered SAM merge over
``torch.distributed``.

Counterpart of ``lamsa_tpu/parallel/multihost.py``. Each process (one
per host, or one per card) aligns the batches it owns, round robin by
batch index, with no traffic between processes on the align path. The
SAM blobs of the batches meet on process 0 through the gloo backend,
which runs on the host in both the CPU and the CUDA builds of torch.
Nothing here finds a cluster by itself: ``initialize`` takes the
coordinator's address, the process count and this process's rank. For
file sinks, ``aln --num-shards`` / ``merge`` (cli.py) need no process
group at all.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join a gloo process group of num_processes at coordinator
    ("host:port", process 0 listens there); nothing for one process."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None:
        raise ValueError("several processes need a coordinator host:port")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group("gloo", init_method=url,
                            world_size=num_processes, rank=process_id)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def my_read_slice(batch_index: int) -> bool:
    """Round-robin batch ownership: process p handles batch i iff
    i % process_count == p. Keeps the input-order merge positional."""
    return batch_index % process_count() == process_index()


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out)


def merge_sam_shards(local_blobs: list[bytes]) -> list[bytes] | None:
    """Gather the per-batch SAM blobs to process 0, which returns them
    in global batch order; None elsewhere.

    Streaming, as the JAX package's: blob counts and lengths are
    exchanged once (two small all-gathers), then each round r (batch r
    of every process, global batches r*P .. r*P+P-1) is one gather to
    process 0, padded only to that round's longest blob."""
    P = process_count()
    if P == 1:
        return local_blobs
    me = process_index()
    n = len(local_blobs)
    counts = _all_gather(torch.tensor([n], dtype=torch.int64))[:, 0]
    nmax = int(counts.max())
    lens = torch.full((nmax,), -1, dtype=torch.int64)
    lens[:n] = torch.tensor([len(b) for b in local_blobs], dtype=torch.int64)
    lens_all = _all_gather(lens).numpy()                      # (P, nmax)
    out: list[bytes] | None = [] if me == 0 else None
    for r in range(nmax):
        lmax = int(max(lens_all[:, r].max(), 0))
        if lmax == 0:                   # an all-empty round moves nothing
            if out is not None:
                out.extend(b"" for p in range(P) if lens_all[p, r] >= 0)
            continue
        buf = torch.zeros(lmax, dtype=torch.uint8)
        if r < n and local_blobs[r]:
            buf[:len(local_blobs[r])] = torch.from_numpy(
                np.frombuffer(local_blobs[r], np.uint8).copy())
        got = [torch.empty_like(buf) for _ in range(P)] if me == 0 else None
        dist.gather(buf, got, dst=0)
        if out is None:
            continue
        for p in range(P):
            if lens_all[p, r] >= 0:
                out.append(got[p][:int(lens_all[p, r])].numpy().tobytes())
    if out is not None:
        assert len(out) == int(counts.sum())
    return out
