"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so the build takes
seconds), written to ``build/lamsa_tpu_torch/`` under the repository
root on first use and loaded with ctypes. Wrappers pass raw device
pointers and the current CUDA stream as integers, under
``torch.cuda.device`` of their inputs' card (a C entry sizes its grid
for, and launches on, the runtime's current device); every C entry
returns ``cudaGetLastError()`` and the wrapper raises if it is not 0.

``WALK_TILES`` states the tile schedule of the two traceback walkers
once: the sources get it as ``-D`` flags, and the numpy mirror of that
schedule in ``ops/testing.py`` reads the same dictionary.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "lamsa_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libkernels.so")
LOG_PATH = os.path.join(BUILD_DIR, "build.log")
# Shared-memory tiles of the walkers (csrc/traceback_adiag.cu,
# csrc/traceback_row.cu): word rows (4 antidiagonals or DP rows each) by
# lanes (int32 words), and how many lanes of a newly staged tile lie left
# of the cursor (the origin is rounded down to 4 lanes = 16 bytes).
WALK_TILES = {
    "ADIAG_TILE_ROWS": 32, "ADIAG_TILE_LANES": 32, "ADIAG_TILE_LEFT": 14,
    "ROW_TILE_ROWS": 32, "ROW_TILE_LANES": 32, "ROW_TILE_LEFT": 14,
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *(f"-D{k}={v}" for k, v in WALK_TILES.items()))

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (all return int = cudaError_t)
_SIGNATURES = {
    # q, t_win, m_len, n_len, lo, zdrop, order, next, dirs32, h_last,
    # best, B, M, W, match, mismatch, gapo, gape, stream
    "lamsa_banded_sw_row": (_P,) * 11 + (_I,) * 7 + (_P,),
    # dirs32, lo, start_i, start_d, steps, term, dbg (or null), B, M, W,
    # stream
    "lamsa_traceback_row": (_P,) * 7 + (_I,) * 3 + (_P,),
    # q, t_win, m_len, n_len, lo, order, next, dirs32a, h_last,
    # B, M, W, match, mismatch, gapo, gape, stream
    "lamsa_banded_sw_adiag": (_P,) * 9 + (_I,) * 7 + (_P,),
    # dirs32a, si, sd, hl, opbits, events, term0, n_ev, dbg (or null),
    # B, A4, V, M, EW, wide, e_slots, stream
    "lamsa_traceback_adiag": (_P,) * 9 + (_I,) * 7 + (_P,),
}


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of lamsa_tpu_torch are built from csrc/ on first use")


def build() -> str:
    """Compile csrc/*.cu into LIB_PATH unless it is newer than every
    source, header and this file (the -D flags); returns the library
    path. One nvcc per source runs in parallel, then one link. The
    compilers' resource reports (-Xptxas -v: registers, shared memory,
    spills) go to LOG_PATH."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    inputs = sources + glob.glob(os.path.join(CSRC, "*.cuh")) \
        + [os.path.abspath(__file__)]
    if os.path.exists(LIB_PATH) and os.path.getmtime(
            LIB_PATH) >= max(os.path.getmtime(s) for s in inputs):
        return LIB_PATH
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
            for s, o in zip(sources, objs)]
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        outs = [p.communicate() for p in procs]
        tmp = f"{LIB_PATH}.{tag}"
        link = [nvcc, "-shared", "-o", tmp, *objs]
        log = [" ".join(c) + "\n" + o + e for c, (o, e) in zip(cmds, outs)]
        bad = [(c, p.returncode, e) for c, p, (_, e) in
               zip(cmds, procs, outs) if p.returncode != 0]
        if not bad:
            r = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + r.stdout + r.stderr)
            if r.returncode != 0:
                bad.append((link, r.returncode, r.stderr))
        with open(LOG_PATH, "w") as fh:
            fh.write("".join(log))
        if bad:
            cmd, rc, err = bad[0]
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
        os.replace(tmp, LIB_PATH)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
