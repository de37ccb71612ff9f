"""Traceback over row-layout direction words: kernel 2 of the port.

``traceback_row`` is the counterpart of the Pallas kernel
``lamsa_tpu.ops.traceback_pallas.traceback_pallas``: it walks every
instance from (start_i, start_d) up to row 0 over ``dirs32`` and
returns per-row step words and the terminal. On a CUDA tensor it
launches ``csrc/traceback_row.cu`` (one warp per instance, walking
tiles of direction words staged in shared memory two at a time); on a
CPU tensor it runs ``traceback_row_plain``, a lockstep torch walk that
advances every instance one row per step, as the TPU kernel does.

Encoding (traceback_pallas.py module docstring): steps[b, r-1] for DP
row r is d_count | op << 16 with op 0 = M, 1 = I, 2 = inactive (rows
above the start cell); term[b, 0] is j at row 0 and term[b, 1] the
final lane. The TPU kernel leaves step words of skipped row groups
undefined; both versions here write op 2 there.
"""

from __future__ import annotations

import threading

import torch

from lamsa_tpu_torch import _build

OP_STEP_M = 0
OP_STEP_I = 1
OP_INACTIVE = 2

LAUNCHES = 0        # kernel launches (CUDA path only)
_count_lock = threading.Lock()


def _count() -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1


def traceback_row(dirs32, lo, start_i, start_d):
    """dirs32 int32[B, M/4, W]; lo, start_i, start_d int32[B].
    Returns (steps int32[B, M], term int32[B, 8])."""
    B, M4, W = dirs32.shape
    for name, x in (("dirs32", dirs32), ("lo", lo), ("start_i", start_i),
                    ("start_d", start_d)):
        if x.device != dirs32.device or x.dtype != torch.int32 \
                or not x.is_contiguous():
            raise ValueError(f"traceback_row: {name} must be a contiguous "
                             f"int32 tensor on {dirs32.device}")
        if x.dim() == 1 and x.shape[0] != B:
            raise ValueError(f"traceback_row: {name} has {x.shape[0]} rows,"
                             f" expected {B}")
    if dirs32.device.type == "cpu":
        return traceback_row_plain(dirs32, lo, start_i, start_d)
    if dirs32.device.type != "cuda":
        raise ValueError(f"traceback_row: no kernel for {dirs32.device}")
    dev = dirs32.device
    M = 4 * M4
    # the C entry launches on the runtime's current device: make it the
    # inputs' card
    with torch.cuda.device(dev):
        steps = torch.empty((B, M), dtype=torch.int32, device=dev)
        term = torch.empty((B, 8), dtype=torch.int32, device=dev)
        rc = _build.lib().lamsa_traceback_row(
            dirs32.data_ptr(), lo.data_ptr(), start_i.data_ptr(),
            start_d.data_ptr(), steps.data_ptr(), term.data_ptr(), None, B,
            M, W, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "lamsa_traceback_row")
    _count()
    return steps, term


def traceback_row_plain(dirs32, lo, start_i, start_d):
    """Plain torch version of traceback_row: a lockstep walk over rows
    max(start_i) .. 1 on (B, W) tensors. The D run at a row is the
    suffix-AND run of chain bits below the current lane (cummin over the
    reversed lanes), as in the TPU kernel."""
    B, M4, W = dirs32.shape
    M = 4 * M4
    dev = dirs32.device
    i64 = torch.int64
    lanes = torch.arange(W, dtype=i64, device=dev)[None, :]
    zcol = torch.zeros((B, 1), dtype=i64, device=dev)
    si = start_i.to(i64)
    d = start_d.to(i64)
    in_f = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = torch.full((B, M), OP_INACTIVE << 16, dtype=torch.int32,
                       device=dev)

    def at(x, idx, ok):
        """x[b, idx[b]] where ok, else 0."""
        g = x.gather(1, idx.clamp(0, W - 1)[:, None])[:, 0]
        return torch.where(ok, g, 0)

    max_si = int(si.max()) if B else 0
    for r in range(max_si, 0, -1):
        act = si >= r
        byte = (dirs32[:, (r - 1) // 4, :].to(i64) >> (8 * ((r - 1) % 4))) \
            & 0xF
        src = byte & 3
        e_ext = (byte >> 2) & 1
        f_ext = (byte >> 3) & 1
        is_e = (src == 1).to(i64)
        # chain bit c[y] = is_e[y] | e_ext[y+1]
        c = is_e | torch.cat([e_ext[:, 1:], zcol], dim=1)
        d_in = (d >= 0) & (d < W)
        start_bit = at(is_e, d, d_in)
        below = lanes < d[:, None]
        c_p = torch.where(below, c, 1)
        sa = torch.flip(torch.cummin(torch.flip(c_p, [1]), dim=1).values,
                        [1])
        emit = below & (start_bit[:, None] == 1) & (sa == 1)
        count_h = emit.sum(dim=1) + start_bit
        x = d - count_h
        x_in = (x >= 0) & (x < W)
        src_x = at(src, x, x_in)
        h_is_m = src_x == 0
        h_op = torch.where(h_is_m, OP_STEP_M, OP_STEP_I)
        h_new = torch.where(h_is_m, x, x + 1)
        h_newf = torch.where(h_is_m, 0, at(f_ext, x, x_in))
        count = torch.where(in_f, 0, count_h)
        op = torch.where(in_f, OP_STEP_I, h_op)
        newlane = torch.where(in_f, d + 1, h_new)
        newf = torch.where(in_f, at(f_ext, d, d_in), h_newf)
        steps[:, r - 1] = torch.where(act, count | (op << 16),
                                      OP_INACTIVE << 16).to(torch.int32)
        d = torch.where(act, newlane, d)
        in_f = torch.where(act, newf == 1, in_f)
    term = torch.zeros((B, 8), dtype=torch.int32, device=dev)
    term[:, 0] = (lo.to(i64) + d).to(torch.int32)
    term[:, 1] = torch.where(si >= 1, d, 0).to(torch.int32)
    return steps, term
