# Copy of the functions of lamsa_tpu/native/__init__.py and
# lamsa_tpu/native/build.py that this package calls, without their
# pure-Python fallbacks: a failed build or call raises.
"""ctypes loaders for the native host library (``lamsa_native.cpp``)
and for the FM index build on every core (``fm_build.cpp``, which
``index/fm_build.py`` drives; a library of its own, so that only a
process that builds an FM index compiles it).

Each library is compiled with g++ on first use into
``build/lamsa_tpu_torch/`` under the repository root (never into the
source directory), to a temporary name and renamed into place, so
processes that start together do not read a half-written file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from lamsa_tpu_torch._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "lamsa_native.cpp")
SO = os.path.join(BUILD_DIR, "_lamsa_native.so")
FM_SRC = os.path.join(_HERE, "fm_build.cpp")
FM_SO = os.path.join(BUILD_DIR, "_fm_build.so")

_lib = None
_fm_lib = None
_load_lock = threading.Lock()

MAXC_DEFAULT = 4096


def build(src: str = SRC, so: str = SO, flags: tuple = ()) -> str:
    """Compile src into so unless so is newer; returns so."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           *flags, src, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native library build failed: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"native library build failed:\n{r.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        i8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        c = ctypes.c_int32
        lib.lamsa_revcomp4.argtypes = [i8p, ctypes.c_int64, i8p]
        lib.lamsa_decode_compact.argtypes = [i32p, u16p, i32p, i32p, i32p, c,
                                             c, c, u32p, c, i32p]
        lib.lamsa_decode_compact.restype = c
        lib.lamsa_decode_compact_wide.argtypes = [i32p, i32p, i32p, i32p,
                                                  i32p, c, c, c, u32p, c,
                                                  i32p]
        lib.lamsa_decode_compact_wide.restype = c
        lib.lamsa_banded_sw_tb.argtypes = [i8p, c, i8p, c, c, c, c, c, c, c,
                                           c, c, u32p, c, i32p]
        lib.lamsa_banded_sw_tb.restype = c
        lib.lamsa_anchors_to_blocks.argtypes = [i64p, ctypes.c_int64, c,
                                                i64p]
        lib.lamsa_anchors_to_blocks.restype = ctypes.c_int64
        lib.lamsa_backtrack_chains.argtypes = [
            i32p, i32p, i32p, i32p, i8p, c, c, c, c, c, c, ctypes.c_double,
            c, i32p, i32p, i32p, i32p]
        lib.lamsa_backtrack_chains.restype = c
        lib.lamsa_sais_u8.argtypes = [i8p, u32p, ctypes.c_int64, c]
        lib.lamsa_sais_u8.restype = c
        lib.lamsa_bwt_from_sa.argtypes = [i8p, u32p, ctypes.c_int64, i8p]
        lib.lamsa_bwt_from_sa.restype = ctypes.c_int64
        _lib = lib
    return _lib


def load_fm_build():
    """The FM build library (``fm_build.cpp``), built on first use."""
    global _fm_lib
    with _load_lock:
        if _fm_lib is not None:
            return _fm_lib
        lib = ctypes.CDLL(build(FM_SRC, FM_SO, ("-pthread",)))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        lib.lamsa_fm_text.argtypes = [u8p, i64, u8p, i32]
        lib.lamsa_fm_text.restype = None
        lib.lamsa_fm_sais.argtypes = [u8p, u32p, i64, i32, i32]
        lib.lamsa_fm_sais.restype = i32
        lib.lamsa_fm_arrays.argtypes = [u8p, u32p, i64, i32, u32p, u32p,
                                        u32p, u32p, u32p, i64, i64p, i32]
        lib.lamsa_fm_arrays.restype = i64
        _fm_lib = lib
    return _fm_lib


def available() -> bool:
    """True when the library is built (or builds now) and loads."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _runs_to_cigar(ops: np.ndarray, n: int) -> np.ndarray:
    """Slice one decoded instance out of the shared output buffer.

    Returns the packed uint32 run array itself (the pipeline-wide hot
    CIGAR representation, io/sam.py::cigar_pairs) — copied, because the
    buffer is reused by the next batch."""
    return ops[:n].copy()


# Reused output buffers for the batch decoders. Fresh np.empty of
# B x maxc uint32 costs ~50 us per first-touched page on this VM
# (firecracker EPT faults) — measured 0.8-3 s per 64 MB allocation,
# which dwarfed the actual C decode (0.6 ms). Thread-local: the batch
# pipeline (pipeline/aln.py align_reads) may run two collect loops
# concurrently. Unlike the JAX package, whose chunks come in a few
# padded sizes, this package's chunks have their real instance counts:
# one buffer per (B, maxc) grew host memory with every new count over a
# long run, so each thread keeps one buffer per maxc, grown to the next
# power of two >= B, and hands out its first B rows.
_buf_cache = threading.local()


def _out_buffers(B: int, maxc: int):
    cache = getattr(_buf_cache, "d", None)
    if cache is None:
        cache = _buf_cache.d = {}
    bufs = cache.get(maxc)
    if bufs is None or len(bufs[1]) < B:
        cap = 1 << max(B - 1, 0).bit_length()
        bufs = (np.empty((cap, maxc), np.uint32), np.empty(cap, np.int32))
        bufs[0].fill(0)                 # touch pages once
        cache[maxc] = bufs
    return bufs[0][:B], bufs[1][:B]


def revcomp4(codes: np.ndarray) -> np.ndarray:
    lib = _load()
    codes = np.ascontiguousarray(codes, np.uint8)
    out = np.empty(len(codes), np.uint8)
    lib.lamsa_revcomp4(codes, len(codes), out)
    return out


def decode_compact_batch(opbits: np.ndarray, events: np.ndarray,
                         term0: np.ndarray, start_i: np.ndarray,
                         n_ev: np.ndarray, maxc: int = MAXC_DEFAULT,
                         wide: bool = False):
    """Batch decode of the compact device-traceback output (op bitmap +
    sparse D events; see ops/banded_sw.py::_dp_tb_fused). Narrow
    format: 16-bit events packed 2-per-int32-word; wide (M > 2048
    buckets): one int32 event per word (ops/banded_sw.py compact_wide).
    Instances that overflowed on device (too many events, or a D run
    too long for the count field) decode to None — callers recompute
    those with banded_sw_tb."""
    lib = _load()
    B, nw = opbits.shape
    evs = np.ascontiguousarray(events, np.int32)
    # narrow: little-endian uint16 view, event e of instance b at [b, e]
    evv = evs if wide else evs.view(np.uint16)
    E = evv.shape[1]
    opbits = np.ascontiguousarray(opbits, np.int32)
    t0 = np.ascontiguousarray(term0, np.int32)
    si = np.ascontiguousarray(start_i, np.int32)
    ne = np.ascontiguousarray(n_ev, np.int32)
    # a decode emits <= 2 runs per DP row + the terminal D run
    maxc = min(maxc, 2 * nw * 32 + 2)
    out_ops, out_n = _out_buffers(B, maxc)
    fn = lib.lamsa_decode_compact_wide if wide else lib.lamsa_decode_compact
    fn(opbits, evv, t0, si, ne, B, nw, E, out_ops.reshape(-1), maxc,
       out_n)
    res = []
    for b in range(B):
        if out_n[b] == -2:              # event overflow: recompute
            res.append(None)
        elif out_n[b] < 0:              # run buffer: cannot overflow
            raise RuntimeError(f"decode_compact: instance {b} overflowed "
                               f"the {maxc}-run buffer")
        else:
            res.append(_runs_to_cigar(out_ops[b], int(out_n[b])))
    return res


def banded_sw_tb(q: np.ndarray, t: np.ndarray, scores, lo: int, hi: int,
                 si: int, sj: int, maxc: int = MAXC_DEFAULT):
    """Banded DP (oracle contract) + traceback from an arbitrary start
    cell (si, sj). Used to recompute instances whose compact device
    traceback overflowed; bit-identical to the device walk."""
    lib = _load()
    q = np.ascontiguousarray(q, np.uint8)
    t = np.ascontiguousarray(t, np.uint8)
    out_ops = np.empty(maxc, np.uint32)
    out_n = np.empty(1, np.int32)
    rc = lib.lamsa_banded_sw_tb(q, len(q), t, len(t), scores.match,
                                scores.mismatch, scores.gap_open,
                                scores.gap_ext, lo, hi, si, sj, out_ops,
                                maxc, out_n)
    if rc != 0 or out_n[0] < 0:
        raise RuntimeError(f"banded_sw_tb failed (rc {rc}, runs "
                           f"{int(out_n[0])}, buffer {maxc})")
    return _runs_to_cigar(out_ops, int(out_n[0]))


def backtrack_chains_native(f, pred, qpos, strand, valid, *, k, read_len,
                            min_anchors, min_score, max_chains,
                            max_overlap_frac, keep_secondaries):
    """Native greedy chain selection (pipeline/skeleton.py::
    backtrack_chains is the spec). Returns (chains, alt_score) where
    chains is a list of (idxs int32[n], is_secondary, score, strand,
    read_start, read_end) in encounter order — or None when the native
    selection reports failure."""
    lib = _load()
    H = len(f)
    f = np.ascontiguousarray(f, np.int32)
    pred = np.ascontiguousarray(pred, np.int32)
    qpos = np.ascontiguousarray(qpos, np.int32)
    strand = np.ascontiguousarray(strand, np.int32)
    valid = np.ascontiguousarray(valid, np.uint8)
    max_out = max_chains + keep_secondaries + H + 1
    out_idx = np.empty(max(H, 1), np.int32)
    out_off = np.empty(max_out + 1, np.int32)
    out_meta = np.empty(5 * max_out, np.int32)
    out_alt = np.empty(1, np.int32)
    n = lib.lamsa_backtrack_chains(
        f, pred, qpos, strand, valid, H, k, read_len, min_anchors,
        min_score, max_chains, float(max_overlap_frac), keep_secondaries,
        out_idx, out_off, out_meta, out_alt)
    if n < 0:
        return None
    chains = []
    for ci in range(n):
        m = out_meta[5 * ci:5 * ci + 5]
        chains.append((out_idx[out_off[ci]:out_off[ci + 1]].copy(),
                       bool(m[0]), int(m[1]), int(m[2]), int(m[3]),
                       int(m[4])))
    return chains, int(out_alt[0])


def anchors_to_blocks(anchors: np.ndarray, k: int) -> np.ndarray:
    """Native chain-anchors -> exact-match blocks."""
    lib = _load()
    a = np.ascontiguousarray(anchors, np.int64)
    n = len(a)
    out = np.empty((max(n, 1), 3), np.int64)
    m = lib.lamsa_anchors_to_blocks(a.reshape(-1), n, k, out.reshape(-1))
    return out[:m]


def bwt_from_sa(codes: np.ndarray, sa_full: np.ndarray):
    """BWA-style BWT: returns (bwt uint8[n], primary). sa_full must be
    the sentinel-INCLUDED SA (use suffix_array_full)."""
    lib = _load()
    bwt = np.empty(len(codes), np.uint8)
    primary = lib.lamsa_bwt_from_sa(np.ascontiguousarray(codes, np.uint8),
                                    np.ascontiguousarray(sa_full,
                                                         np.uint32),
                                    len(sa_full), bwt)
    return bwt, int(primary)


def suffix_array_full(codes: np.ndarray) -> np.ndarray:
    """Sentinel-included SA (row 0 is the sentinel suffix)."""
    lib = _load()
    n = len(codes)
    T = np.empty(n + 1, np.uint8)
    T[:n] = np.asarray(codes, np.uint8) + 1
    T[n] = 0
    SA = np.empty(n + 1, np.uint32)
    rc = lib.lamsa_sais_u8(T, SA, n + 1, 7)
    if rc != 0:
        raise ValueError("sais failed")
    return SA
