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
  place; :func:`bf16_ulp` is one bfloat16 ulp of each element's magnitude.
- :class:`SyntheticEvalSet` is an in-memory eval dataset of seeded frames
  with boxes and masks, for ``evaluate_dataset`` where no image files or
  cv2 are at hand.
- :func:`tiny_resnet_config` and :func:`tiny_plus_config` are
  ``tests/_tiny.py``'s small configs built with the port's own config
  module (``test_torch_config.py`` holds them equal to ``_tiny.py``'s), for
  the tests that import nothing of the JAX package.
"""

import numpy as np
import torch

from yolact_tpu_torch import MEANS, STD
from yolact_tpu_torch import config as C
from yolact_tpu_torch.kernels.dcn import out_size


def tiny_resnet_config(**kw):
    """yolact_base topology with a tiny ResNet and 128px input."""
    cfg = C.get_config('yolact_base')
    return cfg.copy(
        max_size=128,
        num_classes=5,
        dataset=cfg.dataset.copy(class_names=('a', 'b', 'c', 'd')),
        backbone=cfg.backbone.copy(
            args=((1, 1, 1, 1),),
            pred_scales=((6,), (12,), (24,), (48,), (96,))),
        mask_proto_net=((8, 3, (('padding', 1),)),
                        (None, -2, ()),
                        (8, 1, ())),
        extra_head_net=((16, 3, (('padding', 1),)),),
        fpn=cfg.fpn.copy(num_features=16),
        **kw)


def tiny_plus_config(**kw):
    """yolact_plus_resnet50 topology (DCN stages 2-4, maskiou,
    rescore_mask) with a tiny ResNet and 128px input."""
    cfg = C.get_config('yolact_plus_resnet50')
    return cfg.copy(
        max_size=128,
        num_classes=5,
        dataset=cfg.dataset.copy(class_names=('a', 'b', 'c', 'd')),
        backbone=cfg.backbone.copy(
            args=((1, 1, 1, 1), (0, 1, 1, 1)),
            pred_scales=((6,), (12,), (24,), (48,), (96,))),
        mask_proto_net=((8, 3, (('padding', 1),)),
                        (None, -2, ()),
                        (8, 1, ())),
        extra_head_net=((16, 3, (('padding', 1),)),),
        fpn=cfg.fpn.copy(num_features=16),
        maskiou_net=((8, 3, (('stride', 2),)), (16, 3, (('stride', 2),)),
                     (32, 3, (('stride', 2),))),
        **kw)


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


def bf16_ulp(t):
    """One bfloat16 ulp of |t| (8 significant bits), elementwise, as
    float32; 0 where t is 0."""
    _, e = torch.frexp(t.float())
    return torch.where(t == 0, 0.0,
                       torch.ldexp(torch.ones_like(t.float()), e - 8))


class SyntheticEvalSet:
    """``n`` seeded BGR frames of ``size`` x ``size`` pixels, each with 1-3
    objects of random foreground classes (elliptic masks inside their
    boxes), in the COCODetection item contract that ``evaluate_dataset``
    reads: ``pull_item`` -> (frame normalized as ``BaseTransform`` does for
    a ResNet config at ``max_size == size``, gt ``[k, 5]`` relative boxes
    and 0-based labels, masks ``[k, size, size]``, h, w, 0 crowds)."""

    def __init__(self, n, size, num_classes, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = list(range(1, n + 1))
        self.raw, self.items = [], []
        yy, xx = np.mgrid[:size, :size] + 0.5
        for _ in range(n):
            raw = rng.randint(0, 256, (size, size, 3)).astype(np.float32)
            k = rng.randint(1, 4)
            xy1 = rng.randint(0, size // 2, (k, 2))
            xy2 = xy1 + rng.randint(size // 8, size // 2, (k, 2))
            cx, cy = (xy1 + xy2).T / 2
            rx, ry = (xy2 - xy1).T / 2
            masks = ((((xx[None] - cx[:, None, None]) / rx[:, None, None]) ** 2
                      + ((yy[None] - cy[:, None, None]) / ry[:, None, None])
                      ** 2) <= 1).astype(np.float32)
            labels = rng.randint(0, num_classes - 1, k)
            gt = np.hstack([np.hstack([xy1, xy2]) / size, labels[:, None]])
            img = ((raw - np.float32(MEANS)) / np.float32(STD))[..., ::-1]
            self.raw.append(raw)
            self.items.append((np.ascontiguousarray(img, np.float32), gt,
                               masks, size, size, 0))

    def __len__(self):
        return len(self.items)

    def pull_item(self, index):
        return self.items[index]

    def pull_image(self, index):
        return self.raw[index]


def test_synthetic_eval_set_is_seeded_and_consistent():
    a, b = SyntheticEvalSet(3, 32, 5, seed=1), SyntheticEvalSet(3, 32, 5,
                                                                 seed=1)
    assert len(a) == 3 and a.ids == [1, 2, 3]
    for (img, gt, masks, h, w, crowds), other in zip(a.items, b.items):
        assert img.shape == (32, 32, 3) and img.dtype == np.float32
        assert (h, w, crowds) == (32, 32, 0)
        assert np.array_equal(img, other[0]) and np.array_equal(gt, other[1])
        assert masks.shape == (len(gt), 32, 32) and masks.any(axis=(1, 2)).all()
        assert ((0 <= gt[:, :4]) & (gt[:, :4] <= 1)).all()
        assert set(gt[:, 4]) <= {0, 1, 2, 3}
        for box, m in zip(gt[:, :4] * 32, masks):      # masks inside boxes
            ys, xs = np.nonzero(m)
            assert xs.min() >= box[0] and xs.max() < box[2]
            assert ys.min() >= box[1] and ys.max() < box[3]
    # normalized RGB: channel 0 holds the raw frame's R (BGR index 2)
    np.testing.assert_allclose(a.items[0][0][..., 0] * STD[2] + MEANS[2],
                               a.raw[0][..., 2], rtol=0, atol=1e-3)


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


def test_bf16_ulp():
    t = torch.tensor([1.0, 1.5, -3.0, 2 ** -10, 0.0, 255.0]).bfloat16()
    want = torch.tensor([2 ** -7, 2 ** -7, 2 ** -6, 2 ** -17, 0.0, 1.0])
    assert torch.equal(bf16_ulp(t), want)
    # one ulp up is the next bfloat16 value
    up = (t.float() + bf16_ulp(t)).bfloat16()
    assert ulp_distance(up[:4], t[:4]) == 1


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
