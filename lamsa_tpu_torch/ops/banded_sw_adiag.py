"""Global-only banded affine DP in antidiagonal order: kernel 3 of the port.

``banded_sw_adiag`` is the counterpart of the Pallas kernel
``lamsa_tpu.ops.banded_sw_adiag.banded_sw_adiag`` (entry
``banded_sw_adiag_pre``): the DP of global gap fills, with no zdrop and
no best cell. It takes the row-layout windows of ``wire.gather_windows``
directly (the TPU's pre-shifted window arrays replaced slow gathers and
are not ported) and returns the JAX layout:

  dirs32a  int32[B, A/4, V], A = wire.a_pad(M, W), V = W/2: the
           direction nibble of cell (i, j) is byte (i+j-1) % 4 of word
           (i+j-1) // 4, lane ((j-i-lo) - ((i+j) & 1)) // 2. Nibbles
           equal the row spec's (``lamsa_tpu/ops/oracle.py``); words
           above an instance's m + n are unspecified.
  h_last   int32[B, W]: the H row at i == m (dead lanes may differ only
           below the -20000 floor).

Step a holds every band cell with i + j == a. With lo even
(``wire.global_lo``) and hl = lo >> 1, lane l of step a holds
d = 2l + (a & 1), i = (a >> 1) - hl - l, j = (a >> 1) + (a & 1) + hl + l.
Sources: diag at lane l of step a-2; E at lane l-1 (even a) or l (odd
a) of step a-1; F at lane l+1 (odd a) or l (even a) of step a-1.

On a CUDA tensor ``banded_sw_adiag`` launches ``csrc/banded_sw_adiag.cu``;
on a CPU tensor it runs ``banded_sw_adiag_plain``, a loop over the
antidiagonal steps on (B, V) tensors that follows the TPU kernel's
recurrence step for step.
"""

from __future__ import annotations

import threading

import torch

from lamsa_tpu_torch import _build
from lamsa_tpu_torch.ops.wire import NEG_INF, a_pad, longest_first

LAUNCHES = 0        # kernel launches (CUDA path only)
_count_lock = threading.Lock()


def _count() -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1


def _check(q, t_win, m_len, n_len, lo):
    B, M = q.shape
    W = t_win.shape[1] - M
    if W not in (128, 256) or M % 32:
        raise ValueError(f"banded_sw_adiag: unsupported shape M={M} W={W}")
    if t_win.shape != (B, M + W):
        raise ValueError(f"banded_sw_adiag: t_win shape {tuple(t_win.shape)}")
    for name, x in (("q", q), ("t_win", t_win), ("m_len", m_len),
                    ("n_len", n_len), ("lo", lo)):
        if x.device != q.device or x.dtype != torch.int32 \
                or not x.is_contiguous():
            raise ValueError(f"banded_sw_adiag: {name} must be a contiguous "
                             f"int32 tensor on {q.device}")
        if x.dim() == 1 and x.shape[0] != B:
            raise ValueError(f"banded_sw_adiag: {name} has {x.shape[0]} "
                             f"rows, expected {B}")
    return B, M, W


def banded_sw_adiag(q, t_win, m_len, n_len, lo, *, match, mismatch, gapo,
                    gape):
    """Antidiagonal global DP. q int32[B, M], t_win int32[B, M+W]
    (t_win[b, x] = t[x + lo_b], sentinel 5 outside the target); m_len,
    n_len, lo int32[B], lo EVEN. Returns dict dirs32a int32[B, A/4, W/2]
    and h_last int32[B, W] (module docstring)."""
    B, M, W = _check(q, t_win, m_len, n_len, lo)
    if q.device.type == "cpu":
        return banded_sw_adiag_plain(q, t_win, m_len, n_len, lo,
                                     match=match, mismatch=mismatch,
                                     gapo=gapo, gape=gape)
    if q.device.type != "cuda":
        raise ValueError(f"banded_sw_adiag: no kernel for {q.device}")
    dev = q.device
    # the C entry launches on the runtime's current device: make it the
    # inputs' card
    with torch.cuda.device(dev):
        dirs32a = torch.empty((B, a_pad(M, W) // 4, W // 2),
                              dtype=torch.int32, device=dev)
        h_last = torch.empty((B, W), dtype=torch.int32, device=dev)
        order = longest_first(m_len + n_len)
        # the persistent warps' instance counter, zeroed by the C entry
        nxt = torch.empty(1, dtype=torch.int32, device=dev)
        rc = _build.lib().lamsa_banded_sw_adiag(
            q.data_ptr(), t_win.data_ptr(), m_len.data_ptr(),
            n_len.data_ptr(), lo.data_ptr(), order.data_ptr(),
            nxt.data_ptr(), dirs32a.data_ptr(), h_last.data_ptr(), B, M, W,
            match, mismatch, gapo, gape,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "lamsa_banded_sw_adiag")
    _count()
    return {"dirs32a": dirs32a, "h_last": h_last}


def banded_sw_adiag_plain(q, t_win, m_len, n_len, lo, *, match, mismatch,
                          gapo, gape):
    """Plain torch version of banded_sw_adiag: steps 1 .. max(m + n) on
    (B, V) tensors, as lamsa_tpu/ops/banded_sw_adiag.py _kernel. Words
    above max(m + n) stay 0."""
    B, M = q.shape
    W = t_win.shape[1] - M
    V = W // 2
    dev = q.device
    i32 = torch.int32
    NEG = NEG_INF
    # E chain through all-invalid prefixes, and the lane-0 fill that
    # makes the chain equal the spec's exclusive prefix max there
    E_DEAD = NEG - gapo - gape
    E_FILL = NEG - gapo + gape
    if B and bool((lo & 1).any()):
        raise ValueError("banded_sw_adiag: lo must be even")
    lanes = torch.arange(V, dtype=i32, device=dev)[None, :]
    m = m_len[:, None]
    n = n_len[:, None]
    hl = lo[:, None] >> 1                   # arithmetic: lo <= 0
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    fillcol = torch.full((B, 1), E_FILL, dtype=i32, device=dev)
    s_match = torch.tensor(match, dtype=i32, device=dev)
    s_mis = torch.tensor(-mismatch, dtype=i32, device=dev)
    one, two, zero = (torch.tensor(x, dtype=i32, device=dev)
                      for x in (1, 2, 0))

    h1 = torch.where(lanes == -hl, 0, NEG).to(i32)   # step 0: cell (0, 0)
    h2 = torch.full((B, V), NEG, dtype=i32, device=dev)
    e = torch.full((B, V), E_DEAD, dtype=i32, device=dev)
    f = torch.full((B, V), NEG, dtype=i32, device=dev)
    ce = torch.full((B, V), NEG, dtype=i32, device=dev)
    co = torch.full((B, V), NEG, dtype=i32, device=dev)
    dirs32a = torch.zeros((B, a_pad(M, W) // 4, V), dtype=i32, device=dev)
    word = torch.zeros((B, V), dtype=i32, device=dev)

    max_a = int((m_len + n_len).max()) if B else 0
    for a in range(1, max_a + 1):
        par, u = a & 1, a >> 1
        if par == 0:                        # E from lane l-1
            h_e = torch.cat([negcol, h1[:, :-1]], dim=1)
            e_s = torch.cat([fillcol, e[:, :-1]], dim=1)
            h_f, f_s = h1, f
        else:                               # F from lane l+1
            h_f = torch.cat([h1[:, 1:], negcol], dim=1)
            f_s = torch.cat([f[:, 1:], negcol], dim=1)
            h_e, e_s = h1, e
        hg = h_e - gapo
        ebit = e_s >= hg
        if par == 0:
            ebit = ebit & (lanes >= 1)
        e_new = torch.maximum(e_s, hg) - gape          # unclamped chain
        hgf = h_f - gapo
        fbit = f_s >= hgf
        f_new = torch.clamp(torch.maximum(hgf, f_s) - gape, min=NEG)
        ibc = u - hl                        # i at lane 0
        jbc = u + par + hl                  # j at lane 0
        qi = (ibc - lanes - 1).clamp(0, M - 1).long()
        ti = (jbc + lanes - 1 - 2 * hl).clamp(0, M + W - 1).long()
        qc = q.gather(1, qi)
        tc = t_win.gather(1, ti)
        s = torch.where((qc == tc) & (qc < 4) & (tc < 4), s_match, s_mis)
        diag = torch.clamp(h2 + s, min=NEG)
        lo_l = torch.maximum(ibc - m, -jbc)
        hi_l = torch.minimum(ibc - 1, n - jbc)
        valid = (lanes >= lo_l) & (lanes <= hi_l)      # 1<=i<=m, 0<=j<=n
        e_m = torch.where(valid & (lanes >= 1 - jbc),
                          torch.clamp(e_new, min=NEG), NEG)
        f_m = torch.where(valid, f_new, NEG)
        h = torch.where(valid, diag, NEG)
        src = torch.where(e_m > h, one, zero)
        h = torch.maximum(h, e_m)
        src = torch.where(f_m > h, two, src)
        h = torch.maximum(h, f_m)
        nib = torch.where(valid, src | (ebit.to(i32) << 2)
                          | (fbit.to(i32) << 3), 0)
        word |= nib.to(i32) << (8 * ((a - 1) % 4))
        if a % 4 == 0 or a == max_a:
            dirs32a[:, (a - 1) // 4] = word
            word = torch.zeros_like(word)
        # row-0 cells (0, a) enter one lane per step
        r0 = lanes == ibc
        h = torch.where(r0, torch.where(a <= n, -gapo - a * gape, NEG),
                        h).to(i32)
        f_m = torch.where(r0, NEG, f_m).to(i32)
        # h_last capture at i == m, into the parity's array
        capm = lanes == ibc - m
        if par == 0:
            ce = torch.where(capm, h, ce)
        else:
            co = torch.where(capm, h, co)
        h2, h1, e, f = h1, h, e_new.to(i32), f_m
    h_last = torch.stack([ce, co], dim=2).reshape(B, W)
    return {"dirs32a": dirs32a, "h_last": h_last}
