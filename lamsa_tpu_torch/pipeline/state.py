"""Device residency: the index and reference tensors an Aligner keeps.

The JAX package's "parameters" are a numpy ``KmerIndex`` or ``FmIndex``
and a ``PackedReference``; ``lamsa_tpu.pipeline.aln.Aligner.__init__``
turns them into device arrays. ``device_state`` builds the same arrays
as torch tensors on an explicit device:

  ref_words   int32[ceil(len/8)]  4-bit packed reference codes
  k-mer index:
    positions   int64[P]          k-mer occurrence positions (uint32 values)
    keys        int64[K]          sorted k-mer keys
    starts / counts int32[K]      each key's slice of positions
  FM index (ops/fm.py fm_device_state):
    blk, mblk, ssa_pos            int32 uint32 bit patterns
    C, primary, n_rows            int64

Every value is a tensor, so the resident bytes are the sum of their
nbytes. k-mer seeding binary-searches the sorted keys on every device.
The JAX package's dense 4^k direct-address tables work around slow
gathers on the TPU; on the H100 they gave no end-to-end gain (PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from lamsa_tpu_torch.index.fmindex import FmIndex
from lamsa_tpu_torch.ops.fm import fm_device_state
from lamsa_tpu_torch.ops.wire import pack_codes_words
from lamsa_tpu_torch.utils.transfer import to_device


def device_state(ref, index, device) -> dict:
    """Device tensors for a PackedReference + KmerIndex or FmIndex (see
    module docstring for the layout)."""
    dev = torch.device(device)
    st = {"ref_words": to_device(
        torch.from_numpy(pack_codes_words(ref.codes)), dev)}
    if isinstance(index, FmIndex):
        st.update(fm_device_state(index, dev))
        return st
    # copy=False: on the CPU the tensors are the index's own arrays (the
    # loaded index is int64 / int32 already), not a second host copy;
    # only the uint32 keys widen
    st.update({
        "positions": to_device(torch.from_numpy(
            index.positions.astype(np.int64, copy=False)), dev),
        "keys": to_device(torch.from_numpy(index.keys.astype(np.int64)),
                          dev),
        "starts": to_device(torch.from_numpy(
            index.starts.astype(np.int32, copy=False)), dev),
        "counts": to_device(torch.from_numpy(
            index.counts.astype(np.int32, copy=False)), dev),
    })
    return st
