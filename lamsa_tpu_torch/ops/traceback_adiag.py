"""Traceback over antidiagonal direction words: kernel 4 of the port.

``traceback_adiag`` is the counterpart of the Pallas kernel
``lamsa_tpu.ops.banded_sw_adiag.traceback_adiag`` (``_tb_kernel``): it
walks every instance from (si, band offset sd) to row 0 over the
``dirs32a`` of ``banded_sw_adiag`` and writes the compact wire fields
itself:

  opbits  int32[B, M/32]           bit r-1 = 1 for an I step at row r
  events  int32[B, compact_words]  D runs, row-DESCENDING from slot 0;
                                   (row << 5) | cnt two per word, or
                                   wide (row << 13) | cnt for M > 2048
  term0   int32[B]                 j at row 0
  n_ev    int32[B]                 event count, 0xFFFF on overflow

Unlike the row wire, unused event slots are 0 and the overflow test
(run longer than the count field, or an event past the slot budget) is
made as each event is emitted; writes past the last word are dropped.
``wire.collect_group(..., topdown=True)`` decodes it.

On a CUDA tensor ``traceback_adiag`` launches ``csrc/traceback_adiag.cu``
(one warp per instance, walking its cursor through tiles of direction
words staged in shared memory two at a time); on a CPU tensor it
runs ``traceback_adiag_plain``, a lockstep torch sweep over descending
antidiagonals, as the TPU kernel.
"""

from __future__ import annotations

import threading

import torch

from lamsa_tpu_torch import _build
from lamsa_tpu_torch.ops.wire import (compact_E, compact_wide,
                                      compact_words, to_i32)

LAUNCHES = 0        # kernel launches (CUDA path only)
_count_lock = threading.Lock()


def _count() -> None:
    global LAUNCHES
    with _count_lock:
        LAUNCHES += 1


def traceback_adiag(dirs32a, si, sd, hl, *, M):
    """dirs32a int32[B, A/4, V]; si, sd, hl (= lo >> 1) int32[B].
    Returns (opbits int32[B, M/32], events int32[B, compact_words(M)],
    term0 int32[B], n_ev int32[B])."""
    B, A4, V = dirs32a.shape
    if M % 32:
        raise ValueError(f"traceback_adiag: M={M} is not a multiple of 32")
    for name, x in (("dirs32a", dirs32a), ("si", si), ("sd", sd),
                    ("hl", hl)):
        if x.device != dirs32a.device or x.dtype != torch.int32 \
                or not x.is_contiguous():
            raise ValueError(f"traceback_adiag: {name} must be a contiguous "
                             f"int32 tensor on {dirs32a.device}")
        if x.dim() == 1 and x.shape[0] != B:
            raise ValueError(f"traceback_adiag: {name} has {x.shape[0]} "
                             f"rows, expected {B}")
    if dirs32a.device.type == "cpu":
        return traceback_adiag_plain(dirs32a, si, sd, hl, M=M)
    if dirs32a.device.type != "cuda":
        raise ValueError(f"traceback_adiag: no kernel for {dirs32a.device}")
    dev = dirs32a.device
    EW = compact_words(M)
    # the C entry launches on the runtime's current device: make it the
    # inputs' card
    with torch.cuda.device(dev):
        opbits = torch.empty((B, M // 32), dtype=torch.int32, device=dev)
        events = torch.empty((B, EW), dtype=torch.int32, device=dev)
        term0 = torch.empty(B, dtype=torch.int32, device=dev)
        n_ev = torch.empty(B, dtype=torch.int32, device=dev)
        rc = _build.lib().lamsa_traceback_adiag(
            dirs32a.data_ptr(), si.data_ptr(), sd.data_ptr(), hl.data_ptr(),
            opbits.data_ptr(), events.data_ptr(), term0.data_ptr(),
            n_ev.data_ptr(), None, B, A4, V, M, EW, int(compact_wide(M)),
            compact_E(M), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "lamsa_traceback_adiag")
    _count()
    return opbits, events, term0, n_ev


def traceback_adiag_plain(dirs32a, si, sd, hl, *, M):
    """Plain torch version of traceback_adiag: one sweep step per
    antidiagonal a, from the highest start down to 1; an instance acts
    on the step equal to its cursor (M: a-2; D / I: a-1)."""
    B, A4, V = dirs32a.shape
    A = 4 * A4
    NW = M // 32
    EW = compact_words(M)
    wide = compact_wide(M)
    e_slots = compact_E(M)
    CMAX, RSH = (8191, 13) if wide else (30, 5)
    dev = dirs32a.device
    i64 = torch.int64
    si, sd, hl = si.to(i64), sd.to(i64), hl.to(i64)
    sj = si + 2 * hl + sd
    sa = si + sj
    i = si.clone()
    l = (sd - (sa & 1)) >> 1
    zero = torch.zeros(B, dtype=i64, device=dev)
    mode, pend, evc = zero.clone(), zero.clone(), zero.clone()
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    term0 = torch.where(si == 0, sj, 0)
    acur = torch.where(si == 0, 0, sa)
    op = torch.zeros((B, NW), dtype=i64, device=dev)
    ev = torch.zeros((B, EW), dtype=i64, device=dev)

    def rmw_or(x, col, ok, val):
        """x[b, col[b]] |= val[b] where ok[b] (col clamped in range)."""
        c = col.clamp(0, x.shape[1] - 1)[:, None]
        cur = x.gather(1, c)[:, 0]
        x.scatter_(1, c, torch.where(ok, cur | val, cur)[:, None])

    a_max = int(torch.where(acur <= A, acur, 0).max()) if B else 0
    for a in range(a_max, 0, -1):
        active = (acur == a) & (i >= 1)
        word = dirs32a[:, (a - 1) // 4, :].to(i64) & 0xFFFFFFFF
        lin = (l >= 0) & (l < V)
        sel = word.gather(1, l.clamp(0, V - 1)[:, None])[:, 0]
        nib = (torch.where(lin, sel, 0) >> (8 * ((a - 1) % 4))) & 0xF
        src = nib & 3
        eext = (nib >> 2) & 1
        fext = (nib >> 3) & 1
        isE = active & ((mode == 1) | ((mode == 0) & (src == 1)))
        isF = active & ((mode == 2) | ((mode == 0) & (src == 2)))
        isM = active & (mode == 0) & (src == 0)
        commit = isM | isF
        ebm = commit & (pend > 0)
        widx = (i - 1) >> 5
        rmw_or(op, widx, isF & (widx < NW), 1 << ((i - 1) & 31))
        val = ((i - 1) << RSH) | pend.clamp(max=CMAX)
        if wide:
            rmw_or(ev, evc, ebm & (evc < EW), val)
        else:
            slot = evc >> 1
            rmw_or(ev, slot, ebm & (slot < EW), val << (16 * (evc & 1)))
        ovf = ovf | (ebm & ((pend > CMAX) | (evc >= e_slots)))
        evc = evc + ebm.to(i64)
        pend = torch.where(isE, pend + 1, torch.where(commit, 0, pend))
        i2 = i - commit.to(i64)
        a2 = acur - 2 * isM.to(i64) - (isE | isF).to(i64)
        if a % 2 == 0:
            l = l - isE.to(i64)                 # even a: D moves l-1
        else:
            l = l + isF.to(i64)                 # odd a: I moves l+1
        mode = torch.where(isE, eext, torch.where(
            isF, 2 * fext, torch.where(isM, 0, mode)))
        fin = commit & (i2 == 0)
        term0 = torch.where(fin, a2, term0)
        acur = torch.where(fin, 0, torch.where(active, a2, acur))
        i = i2
    n_ev = torch.where(ovf, 0xFFFF, evc)
    return (to_i32(op), to_i32(ev), term0.to(torch.int32),
            n_ev.to(torch.int32))
