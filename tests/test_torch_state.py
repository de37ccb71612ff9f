"""Device residency of the PyTorch port (pipeline/state.py) against the
arrays the JAX package's Aligner builds from the same KmerIndex and
PackedReference (lamsa_tpu/pipeline/aln.py Aligner.__init__,
ops/banded_sw.py pack_ref_device); the port gets its own index and
reference, built from the same codes. Exact equality."""

import numpy as np
import torch

from lamsa_tpu.ops.banded_sw import pack_ref_device
from lamsa_tpu.pipeline.aln import Aligner as JaxAligner
from lamsa_tpu_torch.ops.testing import port_world
from lamsa_tpu_torch.pipeline.state import device_state
from tests.test_e2e import CFG, make_ref

torch.set_num_threads(1)


def test_device_state_matches_jax_arrays():
    genome, ref, idx = make_ref(np.random.default_rng(11), 50000)
    jax_dev = JaxAligner(ref, idx, CFG)._dev      # CPU engine: sorted table
    st = device_state(*port_world(ref, idx), "cpu")
    assert sorted(st) == ["counts", "keys", "positions", "ref_words",
                          "starts"]
    for name in ("keys", "starts", "counts", "positions"):
        assert st[name].device.type == "cpu"
        np.testing.assert_array_equal(
            st[name].numpy(),
            np.asarray(jax_dev[name]).astype(st[name].numpy().dtype),
            err_msg=name)
    assert st["ref_words"].dtype == torch.int32
    np.testing.assert_array_equal(st["ref_words"].numpy(),
                                  np.asarray(pack_ref_device(ref.codes)))
