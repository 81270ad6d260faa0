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
  cv2 are at hand; :class:`SizedEvalSet` the same at COCO's image sizes
  with one crowd annotation per image, and :class:`OraclePipeline` answers
  its frames with detections made from the gt (a non-zero mAP from any
  weights); :class:`SyntheticTrainSet` the training counterpart, raw
  frames of mixed sizes through a training transform, for ``cli/train``.
- :func:`make_train_batch` is a seeded training batch in the contract of
  ``data/coco.py:pad_batch`` (boxes, labels with one crowd per image and
  padding, rectangular masks), as ``tests/test_train.py:make_batch`` builds
  one for the JAX package.
- :func:`cv2_generic` is a fixture that turns cv2's Intel IPP paths off
  for one test, so the JAX package's cv2 resize takes cv2's generic path,
  which ``data/augmentations.py:resize_linear`` reproduces bit for bit.
- :func:`tiny_resnet_config` and :func:`tiny_plus_config` are
  ``tests/_tiny.py``'s small configs built with the port's own config
  module (``test_torch_config.py`` holds them equal to ``_tiny.py``'s), for
  the tests that import nothing of the JAX package;
  :func:`tiny_darknet_config`, :func:`tiny_vgg_config` and
  :func:`tiny_gn_config` the other backbone families at small widths (the
  spatial tests);
  :func:`tiny_option_overrides` turns on every lincomb head and protonet
  option of the reference at once (with a grid from :func:`write_grid`
  and ``CAT_DECONV_HEAD``).
"""

import numpy as np
import pytest
import torch

from yolact_tpu_torch import MEANS, STD
from yolact_tpu_torch import config as C
from yolact_tpu_torch.kernels.dcn import out_size


@pytest.fixture
def cv2_generic():
    """cv2 with IPP off during the test, restored after it (IPP's float
    INTER_LINEAR, which cv2 takes for 1, 3 or 4 channels where it is built
    in, rounds its own way: within 1.6e-2 on the 0-255 scale of cv2's
    generic path)."""
    import cv2
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield cv2
    finally:
        cv2.ipp.setUseIPP(before)


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


def tiny_vgg_config(**kw):
    """yolact_vgg16 (no FPN, one head per level, protonet on the stride-8
    group, BN on group 3, the ceil-mode pool, fc6's dilation 6, four SSD
    extras whose last two shrink without padding) at 8-64 channels and
    300 px: levels of 38, 19, 10, 5, 3 and 1 rows."""
    arch = ((8, 8),
            ('M', 16, 16),
            ('M', 16, 16, 16),
            (('M', (('ceil_mode', True), ('kernel_size', 2), ('stride', 2))),
             32, 32, 32),
            ('M', 32, 32, 32),
            (('M', (('kernel_size', 3), ('padding', 1), ('stride', 1))),
             (64, (('dilation', 6), ('kernel_size', 3), ('padding', 6))),
             (64, (('kernel_size', 1),))))
    cfg = C.get_config('yolact_vgg16')
    return cfg.copy(
        max_size=300, num_classes=5,
        dataset=cfg.dataset.copy(class_names=('a', 'b', 'c', 'd')),
        backbone=cfg.backbone.copy(
            args=(arch, ((16, 2), (8, 2), (8, 1), (8, 1)), (3,))),
        mask_proto_net=((8, 3, (('padding', 1),)), (None, -2, ()),
                        (8, 1, ())),
        extra_head_net=((16, 3, (('padding', 1),)),), **kw)


def tiny_darknet_config(**kw):
    """yolact_darknet53's topology (stride-2 convs, LeakyReLU, batch norm,
    FPN with downsample convs) with one block a stage, at 128 px
    (``tests/_tiny.py``'s)."""
    cfg = C.get_config('yolact_darknet53')
    return cfg.copy(
        max_size=128, num_classes=5,
        backbone=cfg.backbone.copy(
            args=((1, 1, 1, 1, 1),),
            pred_scales=((6,), (12,), (24,), (48,), (96,))),
        mask_proto_net=((8, 3, (('padding', 1),)), (None, -2, ()),
                        (8, 1, ())),
        extra_head_net=((16, 3, (('padding', 1),)),),
        fpn=cfg.fpn.copy(num_features=16), **kw)


def tiny_gn_config(**kw):
    """The tiny ResNet with group norm (RESNET101_GN_BACKBONE's type)."""
    cfg = tiny_resnet_config(**kw)
    return cfg.copy(backbone=cfg.backbone.copy(type='resnet_gn'))


PAD1 = (('padding', 1),)
# an extra head net with a 'cat' of a conv and a transposed conv + conv
# pair that keeps the size, then a stride-1 transposed conv (k3, p1)
CAT_DECONV_HEAD = (('cat', (((6, 3, PAD1),),
                            ((4, -2, (('stride', 2),)),
                             (6, 2, (('stride', 2),))))),
                   (16, -3, PAD1))


def write_grid(path, hw=16, channels=3):
    """A ``mask_proto_grid_file`` at the tiny config's P3 size (128 / 8):
    smooth [g, h, w] coordinate features, as ``scripts/make_grid.py
    --basis`` writes them.  Returns the path."""
    y, x = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw),
                       indexing='ij')
    grid = np.stack([x, y, np.hypot(x - 0.5, y - 0.5)][:channels])
    np.save(path, grid.astype(np.float32))
    return str(path)


def tiny_option_overrides(grid_file):
    """Every lincomb option the reference builds together, for the tiny
    config (as chip_smoke.py's OPTIONS at full size): 9 prototypes with the
    bias channel, the grid, prototypes as features, the coefficient gate,
    mask scoring, instance coefficients, the DSSD prediction module, YOLO
    regressors and ``CAT_DECONV_HEAD``."""
    return dict(mask_proto_bias=True, mask_proto_prototypes_as_features=True,
                mask_proto_coeff_gate=True, use_mask_scoring=True,
                use_instance_coeff=True, use_prediction_module=True,
                use_yolo_regressors=True, mask_proto_use_grid=True,
                mask_proto_grid_file=grid_file,
                extra_head_net=CAT_DECONV_HEAD)


def make_train_batch(rng, cfg, B=2, G=6, n=3):
    """`n` gts per image, the last a crowd (-1), the rest of the G rows
    padding (-2); `rng` is a numpy RandomState."""
    S = cfg.max_size
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.full((B, G), -2, np.int32)
    masks = np.zeros((B, G, S, S), np.uint8)
    for b in range(B):
        for g in range(n):
            x1, y1 = rng.rand(2) * 0.5
            w, h = rng.rand(2) * 0.4 + 0.1
            boxes[b, g] = [x1, y1, min(x1 + w, 1), min(y1 + h, 1)]
            labels[b, g] = rng.randint(0, cfg.num_classes - 1)
            xs = slice(int(x1 * S), int(min(x1 + w, 1) * S))
            ys = slice(int(y1 * S), int(min(y1 + h, 1) * S))
            masks[b, g, ys, xs] = 1
        labels[b, n - 1] = -1  # one crowd
    return dict(image=rng.rand(B, S, S, 3).astype(np.float32),
                gt_boxes=boxes, gt_labels=labels, gt_masks=masks,
                num_gts=np.full(B, n, np.int32),
                num_crowds=np.ones(B, np.int32))


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


def _ellipses(rng, k, h, w):
    """k seeded elliptic masks [k, h, w] and their boxes [k, 4] (absolute
    x1, y1, x2, y2, each mask inside its box)."""
    yy, xx = np.mgrid[:h, :w] + 0.5
    xy1 = np.stack([rng.randint(0, w // 2, k), rng.randint(0, h // 2, k)], 1)
    wh = np.stack([rng.randint(w // 8, w // 2, k),
                   rng.randint(h // 8, h // 2, k)], 1)
    xy2 = xy1 + wh
    cx, cy = (xy1 + xy2).T / 2
    rx, ry = wh.T / 2
    masks = ((((xx[None] - cx[:, None, None]) / rx[:, None, None]) ** 2
              + ((yy[None] - cy[:, None, None]) / ry[:, None, None]) ** 2)
             <= 1).astype(np.float32)
    return masks, np.hstack([xy1, xy2]).astype(np.float64)


class SizedEvalSet:
    """``n`` seeded eval items at image sizes ``sizes`` (h, w), taken in
    turn, in the COCODetection item contract: 1-3 objects of random
    foreground classes and, last, one crowd annotation, elliptic masks
    ``[k + 1, h, w]``.  The network input stands for the frame after
    ``BaseTransform``: a seeded random frame at ``max_size`` x
    ``max_size``, normalized as :class:`SyntheticEvalSet`'s (no image
    files, no resize, no cv2)."""

    def __init__(self, n, sizes, max_size, num_classes, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = list(range(1, n + 1))
        self.items = []
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            k = rng.randint(1, 4)
            masks, boxes = _ellipses(rng, k + 1, h, w)
            labels = rng.randint(0, num_classes - 1, k + 1)
            gt = np.hstack([boxes / [w, h, w, h], labels[:, None]])
            raw = rng.randint(0, 256, (max_size, max_size, 3))
            img = ((raw - np.float32(MEANS)) / np.float32(STD))[..., ::-1]
            self.items.append((np.ascontiguousarray(img, np.float32), gt,
                               masks, h, w, 1))

    def __len__(self):
        return len(self.items)

    def pull_item(self, index):
        return self.items[index]


class OraclePipeline:
    """Stands in for ``infer.Pipeline`` in ``evaluate_dataset`` over an
    eval set: answers each frame with detections made from its own gt,
    recognised by the frame's bytes.  Per gt object (the crowd included) a
    detection of its class, its box moved by a few pixels and its mask
    averaged down to the prototypes' ``proto_hw`` (so that the upsample
    and the 0.5 threshold give back about the gt), plus two false
    positives; seeded scores, at most ``max_num_detections``, the rest
    invalid.  ``masks`` live on ``device``."""

    def __init__(self, dataset, cfg, proto_hw, device='cpu', seed=0):
        self.device = torch.device(device)
        self.cfg = cfg
        self.by_frame = {}
        rng = np.random.RandomState(seed)
        d = cfg.max_num_detections
        hp, wp = proto_hw
        for img, gt, masks, h, w, _ in dataset.items:
            fp_masks, fp_boxes = _ellipses(rng, 2, h, w)
            boxes = np.vstack([gt[:, :4] * [w, h, w, h]
                               + rng.randint(-3, 4, (len(gt), 4)), fp_boxes])
            m = torch.from_numpy(np.concatenate([masks, fp_masks]))
            small = torch.nn.functional.interpolate(
                m[None], size=(hp, wp), mode='area')[0]
            n = min(len(boxes), d)
            out = dict(boxes=np.zeros((d, 4), np.float32),
                       classes=np.zeros(d, np.int32),
                       scores=np.zeros(d, np.float32),
                       masks=torch.zeros(d, hp, wp),
                       valid=np.zeros(d, bool))
            out['boxes'][:n] = (boxes / [w, h, w, h])[:n]
            out['classes'][:n] = np.concatenate(
                [gt[:, 4], rng.randint(0, cfg.num_classes - 1, 2)])[:n]
            out['scores'][:n] = np.sort(rng.uniform(0.1, 1, n))[::-1]
            out['masks'][:n] = small[:n]
            out['valid'][:n] = True
            self.by_frame[img.tobytes()] = out

    def __call__(self, images):
        from yolact_tpu_torch.infer import InferenceOutput
        outs = [self.by_frame[np.asarray(f, np.float32).tobytes()]
                for f in images]
        stack = {k: torch.as_tensor(np.stack([o[k] for o in outs]))
                 for k in ('boxes', 'classes', 'scores', 'valid')}
        masks = torch.stack([o['masks'] for o in outs]).to(self.device)
        return InferenceOutput(stack['boxes'], stack['classes'],
                               stack['scores'], masks, stack['valid'])


class SyntheticTrainSet:
    """``n`` seeded raw BGR uint8 frames of ``sizes`` (in turn), each with
    1-3 objects of random foreground classes and one crowd, with
    rectangular or elliptic masks inside their boxes, in the
    ``COCODetection`` item contract after ``transform`` (a training
    ``SSDAugmentation``): ``pull_item`` -> (image, gt ``[k, 5]`` relative
    boxes and 0-based labels with the crowd last at -1, masks
    ``[k, S, S]``, h, w, num_crowds).  As ``COCODetection`` does, an item
    whose transform drops every box is replaced by another."""

    def __init__(self, n, sizes, num_classes, transform, seed=0):
        rng = np.random.RandomState(seed)
        self.transform = transform
        self.raw = []
        for i in range(n):
            h, w = sizes[i % len(sizes)]
            k = rng.randint(1, 4) + 1
            xy1 = rng.rand(k, 2) * 0.6
            xy2 = np.minimum(xy1 + 0.15 + rng.rand(k, 2) * 0.3, 1.0)
            boxes = np.hstack([xy1, xy2])
            yy, xx = np.mgrid[:h, :w] + 0.5
            masks = np.zeros((k, h, w), np.uint8)
            for j, (x1, y1, x2, y2) in enumerate(boxes * [w, h, w, h]):
                if j % 2:
                    cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, \
                        (x2 - x1) / 2, (y2 - y1) / 2
                    masks[j] = (((xx - cx) / rx) ** 2
                                + ((yy - cy) / ry) ** 2) <= 1
                else:
                    masks[j, int(y1):int(y2), int(x1):int(x2)] = 1
            labels = np.append(rng.randint(0, num_classes - 1, k - 1), -1)
            self.raw.append((rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                             boxes, masks, labels.astype(np.float64)))

    def __len__(self):
        return len(self.raw)

    def pull_item(self, index):
        frame, boxes, masks, labels = self.raw[index]
        h, w = frame.shape[:2]
        img, masks, boxes, out = self.transform(
            frame, masks.astype(np.float32), boxes.copy(),
            {'num_crowds': 1, 'labels': labels})
        if len(boxes) == 0:
            return self.pull_item((index + 1) % len(self))
        target = np.hstack([boxes, out['labels'][:, None]]).astype(np.float32)
        return img, target, masks, h, w, out['num_crowds']


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


def test_sized_eval_set_and_oracle_pipeline():
    data = SizedEvalSet(4, ((48, 64), (64, 48), (43, 64)), 32, 5, seed=1)
    cfg = C.get_config('yolact_base').copy(max_num_detections=4)
    pipe = OraclePipeline(data, cfg, (8, 8))
    for i, (img, gt, masks, h, w, crowds) in enumerate(data.items):
        assert (h, w) == ((48, 64), (64, 48), (43, 64))[i % 3]
        assert img.shape == (32, 32, 3) and crowds == 1
        assert masks.shape == (len(gt), h, w) and masks.any(axis=(1, 2)).all()
        assert ((0 <= gt[:, :4]) & (gt[:, :4] <= 1)).all()
    out = pipe(np.stack([it[0] for it in data.items[:2]]))
    assert tuple(out.masks.shape) == (2, 4, 8, 8)
    n = min(len(data.items[0][1]) + 2, 4)
    assert out.valid[0].tolist() == [True] * n + [False] * (4 - n)
    assert out.classes[0, 0] == int(data.items[0][1][0, 4])
    assert float(out.masks[0, 0].max()) > 0.5
    assert (np.diff(out.scores[0, :n].numpy()) <= 0).all()


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


def test_make_train_batch_contract():
    cfg = tiny_resnet_config()
    a = make_train_batch(np.random.RandomState(3), cfg, B=2, G=5)
    b = make_train_batch(np.random.RandomState(3), cfg, B=2, G=5)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a['image'].shape == (2, 128, 128, 3)
    assert a['gt_masks'].shape == (2, 5, 128, 128)
    assert (a['gt_labels'][:, 2] == -1).all()
    assert (a['gt_labels'][:, 3:] == -2).all()
    assert (a['gt_labels'][:, :2] >= 0).all()
    assert a['gt_masks'][:, :3].any(axis=(2, 3)).all()
    assert not a['gt_masks'][:, 3:].any()
