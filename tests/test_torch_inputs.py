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
- :func:`near_tie_boxes` gives rows of boxes whose last column's IoU max
  is decided between two IoUs that are equal from different fractions,
  one float32 ulp apart, or equal in their float32 cross products.
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


def _iou_fractions(boxes, col):
    """float32 (inter, union) of each box with `col`, by the operations of
    ops/boxes.py:jaccard in its order."""
    f32 = np.float32
    ix = np.minimum(boxes[:, 2], col[2]) - np.maximum(boxes[:, 0], col[0])
    iy = np.minimum(boxes[:, 3], col[3]) - np.maximum(boxes[:, 1], col[1])
    inter = np.maximum(ix, f32(0)) * np.maximum(iy, f32(0))
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter, (area + (col[2] - col[0]) * (col[3] - col[1])) - inter


def tie_kinds(inter, uni):
    """Per consecutive pair of fractions (a, b): (equal float32 IoUs from
    different fractions, IoUs one float32 ulp apart, equal float32 cross
    products inter_a * union_b == inter_b * union_a of unequal exact
    ones)."""
    q = inter / uni
    exact = (inter[1:].astype(np.float64) * uni[:-1]
             - inter[:-1].astype(np.float64) * uni[1:])
    return ((q[1:] == q[:-1]) & (inter[1:] != inter[:-1]),
            q[1:] == np.nextafter(q[:-1], np.float32(np.inf)),
            (inter[1:] * uni[:-1] == inter[:-1] * uni[1:]) & (exact != 0))


NEAR_TIE_COLUMN = np.array([0.25, 0.25, 0.75, 0.625], np.float32)


def near_tie_boxes(n, k, seed=0):
    """[n, k, 4] float32 boxes (k >= 3) whose last column (the box
    NEAR_TIE_COLUMN) has its IoU max decided between the boxes at k - 3 and
    k - 2 (both orders, in turn): a pair of :func:`tie_kinds`, found by a
    seeded search over 200,000 boxes on a 1/1024 grid and spread over the
    IoU range.  The other boxes lie right of the column box, apart from
    it."""
    rng = np.random.RandomState(seed)
    col = NEAR_TIE_COLUMN
    xy = rng.randint(0, 1024, (200000, 2))
    cand = (np.concatenate([xy, xy + rng.randint(1, 512, (200000, 2))], 1)
            / 1024).astype(np.float32)
    inter, uni = _iou_fractions(cand, col)
    ok = (inter > 0) & (uni > 0)
    order = np.argsort(inter[ok] / uni[ok], kind='stable')
    cand, inter, uni = cand[ok][order], inter[ok][order], uni[ok][order]
    equal, ulp, cross = tie_kinds(inter, uni)
    pick = np.flatnonzero(equal | ulp | cross)
    boxes = np.sort(rng.rand(n, k, 4).astype(np.float32) * np.float32(0.1),
                    -1) + np.float32(0.85)
    for r in range(n):
        a = pick[(r // 2) * len(pick) // ((n + 1) // 2)]
        boxes[r, k - 3:k - 1] = cand[[a, a + 1]] if r % 2 else cand[[a + 1, a]]
        boxes[r, k - 1] = col
    return boxes


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


def test_near_tie_boxes_hold_every_kind_of_tie():
    boxes = near_tie_boxes(40, 6)
    assert boxes.shape == (40, 6, 4) and boxes.dtype == np.float32
    assert np.array_equal(boxes, near_tie_boxes(40, 6))
    assert (boxes[:, -1] == NEAR_TIE_COLUMN).all()
    # each row's pair, in IoU order, is a tie of one of the three kinds
    kinds = np.zeros(3, int)
    for row in boxes:
        inter, uni = _iou_fractions(row[-3:-1], NEAR_TIE_COLUMN)
        order = np.argsort(inter / uni, kind='stable')
        hit = [bool(kind[0]) for kind in tie_kinds(inter[order], uni[order])]
        assert any(hit)
        kinds += hit
        # the filler boxes do not touch the column box
        assert (_iou_fractions(row[:-3], NEAR_TIE_COLUMN)[0] == 0).all()
    assert (kinds > 0).all(), kinds
