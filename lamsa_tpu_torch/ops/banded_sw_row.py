"""Banded affine-gap DP in row order: kernel 1 of the port.

``banded_sw_row`` is the counterpart of the Pallas kernel
``lamsa_tpu.ops.banded_sw_pallas.banded_sw_pallas`` (same inputs, same
outputs: packed direction words ``dirs32``, ``h_last`` and the best
cell). On a CUDA tensor it launches the hand-written kernel in
``csrc/banded_sw_row.cu``; on a CPU tensor it runs
``banded_sw_row_plain``, a torch port of the semantic spec
``lamsa_tpu.ops.banded_sw_xla.banded_sw_batch`` that writes the packed
words directly. Both follow the ``lamsa_tpu/ops/oracle.py`` contract
bit for bit: scores, tie-breaks, direction bytes and zdrop at
``ZDROP_GROUP`` rows. Dead lanes may differ only below the -20000
floor; direction rows above an instance's m are unspecified.
"""

from __future__ import annotations

import threading

import torch

from lamsa_tpu_torch import _build
from lamsa_tpu_torch.ops.wire import NEG_INF, ZDROP_GROUP, longest_first

LAUNCHES = 0        # kernel launches (CUDA path only)
_count_lock = threading.Lock()


def _count() -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1


def _check(q, t_win, m_len, n_len, lo, zdrop):
    B, M = q.shape
    W = t_win.shape[1] - M
    if W not in (128, 256) or M % 32:
        raise ValueError(f"banded_sw_row: unsupported shape M={M} W={W}")
    if t_win.shape != (B, M + W):
        raise ValueError(f"banded_sw_row: t_win shape {tuple(t_win.shape)}")
    for name, x in (("q", q), ("t_win", t_win), ("m_len", m_len),
                    ("n_len", n_len), ("lo", lo), ("zdrop", zdrop)):
        if x.device != q.device or x.dtype != torch.int32 \
                or not x.is_contiguous():
            raise ValueError(f"banded_sw_row: {name} must be a contiguous "
                             f"int32 tensor on {q.device}")
        if x.dim() == 1 and x.shape[0] != B:
            raise ValueError(f"banded_sw_row: {name} has {x.shape[0]} "
                             f"rows, expected {B}")
    return B, M, W


def banded_sw_row(q, t_win, m_len, n_len, lo, zdrop, *, match, mismatch,
                  gapo, gape):
    """Batched banded DP. q int32[B, M], t_win int32[B, M+W]
    (t_win[b, x] = t[x + lo_b], sentinel 5 outside the target), m_len,
    n_len, lo, zdrop int32[B] (zdrop 0 = off). Returns dict
    dirs32 int32[B, M/4, W] (byte p of word w = row 4w + p + 1),
    h_last int32[B, W] (H at row m; NEG_INF if z-dropped first) and
    best int32[B, 3] (score, row, lane; ties -> smallest row, then
    smallest lane)."""
    B, M, W = _check(q, t_win, m_len, n_len, lo, zdrop)
    if q.device.type == "cpu":
        return banded_sw_row_plain(q, t_win, m_len, n_len, lo, zdrop,
                                   match=match, mismatch=mismatch,
                                   gapo=gapo, gape=gape)
    if q.device.type != "cuda":
        raise ValueError(f"banded_sw_row: no kernel for {q.device}")
    dev = q.device
    # the C entry launches on the runtime's current device: make it the
    # inputs' card
    with torch.cuda.device(dev):
        dirs32 = torch.empty((B, M // 4, W), dtype=torch.int32, device=dev)
        h_last = torch.empty((B, W), dtype=torch.int32, device=dev)
        best = torch.empty((B, 3), dtype=torch.int32, device=dev)
        order = longest_first(m_len)
        # the persistent warps' instance counter, zeroed by the C entry
        nxt = torch.empty(1, dtype=torch.int32, device=dev)
        rc = _build.lib().lamsa_banded_sw_row(
            q.data_ptr(), t_win.data_ptr(), m_len.data_ptr(),
            n_len.data_ptr(), lo.data_ptr(), zdrop.data_ptr(),
            order.data_ptr(), nxt.data_ptr(), dirs32.data_ptr(),
            h_last.data_ptr(), best.data_ptr(), B, M, W, match, mismatch,
            gapo, gape, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "lamsa_banded_sw_row")
    _count()
    return {"dirs32": dirs32, "h_last": h_last, "best": best}


def banded_sw_row_plain(q, t_win, m_len, n_len, lo, zdrop, *, match,
                        mismatch, gapo, gape):
    """Plain torch version of banded_sw_row (a row loop over (B, W)
    tensors, as banded_sw_batch's scan). Rows above max(m_len) are not
    computed; their direction words stay 0."""
    B, M = q.shape
    W = t_win.shape[1] - M
    dev = q.device
    i32 = torch.int32
    NEG = NEG_INF
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    lanes_gape = lanes * gape
    lo_b = lo[:, None]
    n_b = n_len[:, None]
    m_b = m_len[:, None]
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    one, two, zero = (torch.tensor(x, dtype=i32, device=dev)
                      for x in (1, 2, 0))
    s_match = torch.tensor(match, dtype=i32, device=dev)
    s_mis = torch.tensor(-mismatch, dtype=i32, device=dev)

    j0 = lo_b + lanes
    h = torch.where(j0 == 0, 0, torch.where(
        (j0 >= 1) & (j0 <= n_b), -(gapo + j0 * gape), NEG)).to(i32)
    f = torch.full((B, W), NEG, dtype=i32, device=dev)
    h_last = torch.where(m_b == 0, h, NEG).to(i32)
    bls = h.clone()                         # per-lane best score
    blr = torch.zeros((B, W), dtype=i32, device=dev)   # its earliest row
    alive = torch.ones((B, 1), dtype=torch.bool, device=dev)
    zd = zdrop[:, None]
    dirs32 = torch.zeros((B, M // 4, W), dtype=i32, device=dev)
    word = torch.zeros((B, W), dtype=i32, device=dev)

    max_m = int(m_len.max()) if B else 0
    for i in range(1, max_m + 1):
        j = i + lo_b + lanes
        valid = (j >= 0) & (j <= n_b)
        h_up = torch.cat([h[:, 1:], negcol], dim=1)
        f_up = torch.cat([f[:, 1:], negcol], dim=1)
        f_ext = f_up >= h_up - gapo
        f_cur = torch.clamp(torch.maximum(h_up - gapo, f_up) - gape, min=NEG)
        qc = q[:, i - 1:i]
        tc = t_win[:, i - 1:i - 1 + W]
        s = torch.where((qc == tc) & (qc < 4) & (tc < 4), s_match, s_mis)
        diag = torch.clamp(h + s, min=NEG)
        h_nogap = torch.where(valid, torch.maximum(diag, f_cur), NEG)
        # E via exclusive prefix max of V = H' + d*gape
        v = h_nogap + lanes_gape
        p_incl = torch.cummax(v, dim=1).values
        p_excl = torch.cat([negcol, p_incl[:, :-1]], dim=1)
        e_cur = torch.where(valid & (j >= 1),
                            torch.clamp(p_excl - lanes_gape - gapo, min=NEG),
                            NEG)
        e_ext = torch.cat([zcol, v[:, :-1] <= p_excl[:, :-1]], dim=1)
        # H source, tie priority diag > E > F
        hh = torch.where(valid, diag, NEG)
        f_m = torch.where(valid, f_cur, NEG)
        src = torch.where(e_cur > hh, one, zero)
        hh = torch.maximum(hh, e_cur)
        src = torch.where(f_m > hh, two, src)
        hh = torch.maximum(hh, f_m)
        live = valid & (i <= m_b)
        hh = torch.where(live, hh, NEG).to(i32)
        f_m = torch.where(live, f_m, NEG).to(i32)
        byte = torch.where(live, src | (e_ext.to(i32) << 2)
                           | (f_ext.to(i32) << 3), 0).to(i32)
        word |= byte << (8 * ((i - 1) % 4))
        if i % 4 == 0 or i == max_m:
            dirs32[:, (i - 1) // 4] = word
            word = torch.zeros_like(word)
        h_last = torch.where((i == m_b) & alive, hh, h_last)
        imp = (hh > bls) & alive                # strict: earliest row
        bls = torch.where(imp, hh, bls)
        blr = torch.where(imp, i, blr).to(i32)
        h, f = hh, f_m
        if i % ZDROP_GROUP == 0:
            cur = hh.amax(dim=1, keepdim=True)
            bb = bls.amax(dim=1, keepdim=True)
            alive = alive & ~((zd > 0) & (cur < bb - zd))

    smax = bls.amax(dim=1, keepdim=True)
    at = bls == smax
    rmin = torch.where(at, blr, 1 << 30).amin(dim=1, keepdim=True)
    dmin = torch.where(at & (blr == rmin), lanes, W).amin(dim=1,
                                                         keepdim=True)
    best = torch.cat([smax, rmin, dmin], dim=1).to(i32)
    return {"dirs32": dirs32, "h_last": h_last, "best": best}
