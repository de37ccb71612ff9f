"""One DP chunk on the device: descriptors in, compact wire out.

Counterpart of ``_dp_tb_fused_gather`` and ``_dp_tb_core`` in
``lamsa_tpu/ops/banded_sw.py``: unpack the (B, 4) descriptor wire,
gather the q / t windows from the resident packed code words, run the
row DP (kernel 1), extract scores, take the extension clip decision,
walk the traceback (kernel 2) and pack the compact wire.

``dp_tb_adiag_gather`` is the all-global chunk of ``_dp_tb_adiag_gather``
/ ``_dp_tb_adiag_core``: the antidiagonal DP (kernel 3) and its walker
(kernel 4), which writes the compact wire itself with D events
row-descending (decode with ``collect_group(..., topdown=True)``).
``pipeline/extend.py`` sends global gap fills there and extensions to
``dp_tb_gather``, as the JAX package does with ADIAG_ENABLED = True.
"""

from __future__ import annotations

import torch

from lamsa_tpu_torch.ops.banded_sw_adiag import banded_sw_adiag
from lamsa_tpu_torch.ops.banded_sw_row import banded_sw_row
from lamsa_tpu_torch.ops.traceback_adiag import traceback_adiag
from lamsa_tpu_torch.ops.traceback_row import traceback_row
from lamsa_tpu_torch.ops.wire import (compact_encode, extract_scores,
                                      gather_windows, to_i32, unpack_desc)


def dp_tb_gather(flat_reads, ref_codes, desc, *, M, W, scores, zdrop=0):
    """One chunk (lamsa_tpu/ops/banded_sw.py _dp_tb_fused_gather and
    _dp_tb_core): flat_reads / ref_codes are the resident int32 packed
    code words, desc the int32[B, 4] descriptor wire (wire.pack_desc).
    Returns the int32 compact wire [B, M/32 + compact_words(M) + 3]."""
    (q_base, q_step, q_comp, t_base, t_step, m_len, n_len, lo, is_global,
     bonus) = unpack_desc(desc)
    q, t_win = gather_windows(flat_reads, ref_codes, q_base, q_step, q_comp,
                              t_base, t_step, m_len, n_len, lo, M=M, W=W)
    i32 = torch.int32
    # zdrop applies to extensions only (a global gap fill must reach its
    # end regardless of interior dips)
    zd = torch.where(is_global, 0, zdrop).to(i32)
    res = banded_sw_row(q, t_win, m_len.to(i32), n_len.to(i32), lo.to(i32),
                        zd, match=scores.match, mismatch=scores.mismatch,
                        gapo=scores.gap_open, gape=scores.gap_ext)
    g, te, te_d = extract_scores(res["h_last"], m_len, n_len, lo)
    best = res["best"].to(torch.int64)
    te_j = m_len + lo + te_d
    # reachability guard: dead last rows floor at NEG_INF; legitimate
    # scores are always > -29000
    use_te = (te > -29000) & (te >= best[:, 0] - bonus)
    si_ext = torch.where(use_te, m_len, best[:, 1])
    sj_ext = torch.where(use_te, te_j, best[:, 1] + lo + best[:, 2])
    sc_ext = torch.where(use_te, te, best[:, 0])
    si = torch.where(is_global, m_len, si_ext)
    sj = torch.where(is_global, n_len, sj_ext)
    score = torch.where(is_global, g, sc_ext)
    sd = sj - si - lo
    steps, term = traceback_row(res["dirs32"], lo.to(i32),
                                si.to(i32).contiguous(),
                                sd.to(i32).contiguous())
    return compact_encode(steps, term, si, sd, score)


def dp_tb_adiag_gather(flat_reads, ref_codes, desc, *, M, W, scores):
    """One all-global chunk on the antidiagonal pair
    (lamsa_tpu/ops/banded_sw.py _dp_tb_adiag_gather and
    _dp_tb_adiag_core); every instance must be global with an even lo
    (wire.global_lo). Returns the int32 compact wire
    [B, M/32 + compact_words(M) + 3] with topdown D events."""
    (q_base, q_step, q_comp, t_base, t_step, m_len, n_len, lo, _is_global,
     _bonus) = unpack_desc(desc)
    q, t_win = gather_windows(flat_reads, ref_codes, q_base, q_step, q_comp,
                              t_base, t_step, m_len, n_len, lo, M=M, W=W)
    i32 = torch.int32
    res = banded_sw_adiag(q, t_win, m_len.to(i32), n_len.to(i32), lo.to(i32),
                          match=scores.match, mismatch=scores.mismatch,
                          gapo=scores.gap_open, gape=scores.gap_ext)
    g, _, _ = extract_scores(res["h_last"], m_len, n_len, lo)
    sd = n_len - m_len - lo
    opbits, events, term0, n_ev = traceback_adiag(
        res["dirs32a"], m_len.to(i32), sd.to(i32), (lo >> 1).to(i32), M=M)
    tail = torch.stack([to_i32(term0.to(torch.int64) | (n_ev.to(torch.int64)
                                                         << 16)),
                        to_i32(m_len | (sd << 16)), to_i32(g)], dim=1)
    return torch.cat([opbits, events, tail], dim=1)
