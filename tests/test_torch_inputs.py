"""Seeded inputs shared by the port's tests, and tests of those inputs.

The module imports no JAX, so ``test_torch_cuda.py`` can use it on the GPU
machine, which has none.  ``chip_smoke.py`` keeps its own copies: a change
to the smoke script's inputs does not move the unit tests.

- :func:`seed_offsets_jax` and :func:`seed_offsets_state_dict` overwrite
  every DCN offset/mask conv with seeded non-zero weights, in a JAX
  variables tree and in a torch state dict.  The zero init of both
  packages puts every DCN sample on a grid point, which would leave the
  bilinear and out-of-bounds paths unexercised.
- :func:`dcn_inputs` gives one DCN block's input, offsets and mask with
  integer, fractional, far out-of-bounds and non-finite offsets.
- :func:`ulp_distance` measures two bfloat16 tensors in units in the last
  place.
"""

import numpy as np
import torch

from yolact_tpu_torch.kernels.dcn import out_size


def seed_offsets_jax(variables, seed=0, w_scale=0.5, b_scale=4.0):
    """Overwrite every DCN offset/mask conv of a JAX variables tree (in
    place) with seeded numpy weights and biases.  At these scales the
    tiny-plus offsets have a std of 4-8 pixels, reach 23, and some leave
    the map entirely."""
    rng = np.random.RandomState(seed)

    def walk(tree, in_dcn):
        for key in sorted(tree):
            value = tree[key]
            if isinstance(value, dict):
                walk(value, in_dcn or key == 'conv_offset_mask')
            elif in_dcn:
                scale = w_scale if key == 'kernel' else b_scale
                tree[key] = (rng.randn(*value.shape) * scale).astype(
                    np.float32)

    walk(variables['params'], False)
    return variables


def seed_offsets_state_dict(sd, gen, w_scale=0.05, b_scale=2.0):
    """A copy of a torch state dict whose DCN offset/mask convs hold
    weights and biases drawn from the torch.Generator `gen`."""
    sd = dict(sd)
    for key in [k for k in sd if 'conv_offset_mask' in k]:
        scale = w_scale if key.endswith('weight') else b_scale
        sd[key] = torch.randn(sd[key].shape, generator=gen) * scale
    return sd


def dcn_inputs(gen, dev, b, cin, h, stride, dtype, finite=False):
    """x [b, cin, h, h], offsets and mask of one 3x3, padding-1 DCN block.
    Offsets mix, per element, integers, fractions of a few pixels, far
    out-of-bounds values (up to 3 map sizes, both signs) and small ones;
    unless `finite`, taps 0-3 of the first pixel have NaN and infinite
    offsets."""
    ho = out_size(h, 3, stride, 1, 1)
    shape = (b, 18, ho, ho)
    kind = torch.randint(0, 4, shape, generator=gen)
    offset = torch.where(
        kind == 0, torch.randint(-4, 5, shape, generator=gen).float(),
        torch.where(kind == 1, torch.randn(shape, generator=gen) * 2,
                    torch.where(kind == 2,
                                (torch.rand(shape, generator=gen) * 2 - 1)
                                * 3 * h,
                                torch.randn(shape, generator=gen) * 0.3)))
    if not finite:     # taps 0-3 of the first pixel: NaN, 0, 0, NaN samples
        nan, inf = float('nan'), float('inf')
        offset[0, :8, 0, 0] = torch.tensor(
            [nan, 0.5, 0.5, inf, -inf, 0.5, 0.5, nan])
    x = torch.randn(b, cin, h, h, generator=gen).to(dtype)
    mask = torch.rand(b, 9, ho, ho, generator=gen).to(dtype)
    return x.to(dev), offset.to(dev), mask.to(dev)


def ulp_distance(a, b):
    """Largest distance in units in the last place between two bfloat16
    tensors of finite values (+0 and -0 are 0 apart)."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)
    return int((ordered(a) - ordered(b)).abs().max())


def test_dcn_inputs_cover_every_offset_kind():
    x, offset, mask = dcn_inputs(torch.Generator().manual_seed(0), 'cpu',
                                 2, 3, 11, 2, torch.bfloat16)
    assert x.shape == (2, 3, 11, 11) and x.dtype == torch.bfloat16
    assert offset.shape == (2, 18, 6, 6) and offset.dtype == torch.float32
    assert mask.shape == (2, 9, 6, 6) and mask.dtype == torch.bfloat16
    first = offset[0, :8, 0, 0]
    assert first.isnan().sum() == 2 and first.isinf().sum() == 2
    finite = offset[offset.isfinite()]
    assert (finite == finite.round()).any()              # integers
    assert (finite != finite.round()).any()              # fractions
    assert (finite.abs() > 11).any()                     # far outside
    assert (finite < 0).any() and (finite > 0).any()
    again = dcn_inputs(torch.Generator().manual_seed(0), 'cpu', 2, 3, 11, 2,
                       torch.bfloat16)
    assert torch.equal(again[0], x) and torch.equal(again[2], mask)
    assert torch.equal(again[1].nan_to_num(), offset.nan_to_num())
    clean = dcn_inputs(torch.Generator().manual_seed(0), 'cpu', 2, 3, 11, 2,
                       torch.float32, finite=True)[1]
    assert bool(clean.isfinite().all())


def test_ulp_distance():
    one = torch.tensor([1.0], dtype=torch.bfloat16)
    step = torch.tensor([1.0 + 2 ** -7], dtype=torch.bfloat16)
    assert ulp_distance(one, one) == 0
    assert ulp_distance(one, step) == ulp_distance(step, one) == 1
    assert ulp_distance(-one, -step) == 1
    zeros = torch.tensor([0.0, -0.0], dtype=torch.bfloat16)
    assert ulp_distance(zeros[:1], zeros[1:]) == 0
    tiny = torch.tensor([2 ** -133], dtype=torch.bfloat16)  # smallest > 0
    assert ulp_distance(-tiny, tiny) == 2


def test_seeded_offsets_are_deterministic_and_nonzero():
    def tree():
        return {'params': {'layers_1': {'0': {'conv2': {
            'conv_offset_mask': {'kernel': np.zeros((3, 3, 4, 27), np.float32),
                                 'bias': np.zeros(27, np.float32)},
            'kernel': np.ones((3, 3, 4, 4), np.float32)}}}}}

    def conv2(v):
        return v['params']['layers_1']['0']['conv2']

    a, b = seed_offsets_jax(tree(), seed=1), seed_offsets_jax(tree(), seed=1)
    com = conv2(a)['conv_offset_mask']
    assert np.all(com['kernel'] != 0) and np.all(com['bias'] != 0)
    assert com['kernel'].dtype == np.float32
    assert np.array_equal(com['kernel'],
                          conv2(b)['conv_offset_mask']['kernel'])
    assert np.all(conv2(a)['kernel'] == 1)

    sd = {'backbone.layers.1.0.conv2.conv_offset_mask.weight':
          torch.zeros(27, 4, 3, 3),
          'backbone.layers.1.0.conv2.conv_offset_mask.bias': torch.zeros(27),
          'backbone.layers.1.0.conv2.weight': torch.ones(4, 4, 3, 3)}
    s1 = seed_offsets_state_dict(sd, torch.Generator().manual_seed(3))
    s2 = seed_offsets_state_dict(sd, torch.Generator().manual_seed(3))
    assert all(torch.equal(s1[k], s2[k]) for k in sd)
    assert all(bool((s1[k] != 0).all()) for k in sd if 'offset' in k)
    assert torch.equal(s1['backbone.layers.1.0.conv2.weight'],
                       sd['backbone.layers.1.0.conv2.weight'])
    assert not sd['backbone.layers.1.0.conv2.conv_offset_mask.bias'].any()
