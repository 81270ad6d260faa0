"""The port's bit-packed mask transport (``yolact_tpu_torch/ops/bits.py``)
against ``yolact_tpu/ops/bits.py``: the host pack byte for byte, the device
unpack bit for bit, and the round trip, at widths that fill no byte, one
byte, a byte and a bit, and the 138 of yolact_base's prototypes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolact_tpu.ops import bits as jax_bits
from yolact_tpu_torch.ops import bits


@pytest.mark.parametrize('width', [1, 7, 8, 9, 138])
def test_round_trip_and_jax(width):
    rng = np.random.RandomState(width)
    masks = (rng.rand(3, 5, width) > 0.5).astype(np.uint8)
    soft = masks * rng.uniform(0.1, 1.0, masks.shape).astype(np.float32)
    packed = bits.pack_bits_last(masks)
    assert packed.dtype == np.uint8
    assert packed.shape == (3, 5, bits.packed_width(width))
    assert bits.packed_width(width) == jax_bits.packed_width(width)
    np.testing.assert_array_equal(packed, jax_bits.pack_bits_last(masks))
    np.testing.assert_array_equal(bits.pack_bits_last(soft), packed)
    got = bits.unpack_bits_last(torch.from_numpy(packed), width)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), masks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_bits.unpack_bits_last(jnp.asarray(packed), width)))
