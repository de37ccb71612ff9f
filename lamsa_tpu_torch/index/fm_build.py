"""The FM index build on every core the process may use.

``build(codes, sa_rate)`` gives the fields of ``index/fmindex.py``
``FmIndex``, equal array for array to the JAX package's
``FmIndex.build``: the text (N substituted, shifted by one, a sentinel)
is made once, the suffix array by a parallel SA-IS, and bwt2, occ and
the sampled SA by two parallel sweeps over 64-row slices of it
(``native/fm_build.cpp``). No uint8 BWT and no numpy temporaries.

The threads are those of the process's CPU affinity; below
``PARALLEL_MIN`` bases the build runs on one thread. Each build records
the spans ``fm_build_sa`` and ``fm_build_arrays`` and adds its threads
to the counter ``fm_build_threads`` (``utils/timers.py`` ``GLOBAL``),
and prints one ``[fmindex build] <phase> (<s>)`` line on stderr after
each phase.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from lamsa_tpu_torch import native
from lamsa_tpu_torch.index.fmindex import OCC_RATE
from lamsa_tpu_torch.utils.timers import GLOBAL

# below this many bases threads cost more than they save: on 8 cores,
# one thread builds 1 Mi bases in 0.09 s and eight in 0.10-0.18 s; at
# 4 Mi one takes 0.41-0.47 s and eight 0.26 s
PARALLEL_MIN = 1 << 21


def _default_threads(n: int) -> int:
    return len(os.sched_getaffinity(0)) if n >= PARALLEL_MIN else 1


def sort_text(codes: np.ndarray, threads: int) -> np.ndarray:
    """The suffix sort's text: ``codes`` with N substituted as
    ``fmindex.substitute_n`` does, plus one, and a sentinel 0 (uint8,
    n + 1)."""
    codes = np.ascontiguousarray(codes, np.uint8)
    text = np.empty(len(codes) + 1, np.uint8)
    native.load_fm_build().lamsa_fm_text(codes, len(codes), text,
                                         threads)
    return text


def suffix_array(text: np.ndarray, threads: int) -> np.ndarray:
    """Suffix array (uint32) of ``sort_text``'s text, sentinel row first;
    ``native.suffix_array_full`` of the substituted codes."""
    sa = np.empty(len(text), np.uint32)
    lib = native.load_fm_build()
    if lib.lamsa_fm_sais(text, sa, len(text), 5, threads) != 0:
        raise RuntimeError("lamsa_fm_sais failed")
    return sa


def build(codes: np.ndarray, sa_rate: int, *, _threads=None) -> dict:
    """FmIndex fields of ``codes`` (uint8, 0-3 and N = 4). ``_threads``
    forces a thread count (for tests)."""
    t0 = time.time()

    def phase(name):
        print(f"[fmindex build] {name} ({time.time() - t0:.0f}s)",
              file=sys.stderr, flush=True)

    n = len(codes)
    if n == 0:
        raise ValueError("FM index of an empty text")
    nt = _threads or _default_threads(n)
    GLOBAL.count("fm_build_threads", nt)
    with GLOBAL.stage("fm_build_sa"):
        text = sort_text(codes, nt)
        sa = suffix_array(text, nt)
    phase("suffix array")
    with GLOBAL.stage("fm_build_arrays"):
        nr = n + 1
        bwt2 = np.empty((n + 15) // 16, np.uint32)
        occ = np.empty((n // OCC_RATE + 1, 4), np.uint32)
        ssa_marks = np.empty((nr + 31) // 32, np.uint32)
        ssa_rankcp = np.empty(nr // 64 + 1, np.uint32)
        ssa_pos = np.empty(n // sa_rate + 1, np.uint32)
        counts = np.empty(4, np.int64)
        primary = native.load_fm_build().lamsa_fm_arrays(
            text, sa, n, sa_rate, bwt2, occ.reshape(-1), ssa_marks,
            ssa_rankcp, ssa_pos, len(ssa_pos), counts, nt)
        if primary < 0:
            raise RuntimeError(f"lamsa_fm_arrays failed ({primary})")
        del sa, text
    phase("bwt, occ and sampled SA")
    C = np.zeros(5, np.int64)
    C[1:] = np.cumsum(counts)
    C += 1                                             # sentinel row
    return dict(n=n, primary=int(primary), counts=counts, C=C, bwt2=bwt2,
                occ=occ, ssa_marks=ssa_marks, ssa_rankcp=ssa_rankcp,
                ssa_pos=ssa_pos, sa_rate=sa_rate)
