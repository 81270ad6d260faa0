"""The training augmentation on the card.  Port of
``yolact_tpu/data/device_augment.py``.

The host pipeline (``data/augmentations.py:SSDAugmentation``) costs the
loader's threads numpy work per image; this module runs the whole
geometric and photometric pipeline on the device, batched over the images
of a batch:

  photometric distort -> expand -> random-sample-crop -> resize -> mirror
  -> vertical flip -> rot90 (the last two gated by augment_random_flip,
  the reference's flip-gates-rot90 quirk)

The geometric stages compose into ONE axis-aligned affine map per image
(scale and translate per axis, a negative scale for mirror or flip),
applied as one separable bilinear gather (``torch.gather``) to the image
and all its gt masks; rot90 is an exact permutation of the warped square
output.  The host loader only decodes and resizes to S x S
(``data/augmentations.py:RawResize``).

Semantics follow the reference's distributions, as JAX's module does:

  * brightness U(-32,32), contrast x U(0.5,1.5), saturation x U(0.5,1.5),
    hue +- 18 deg, each with p=1/2, contrast before-or-after HSV with p=1/2
    (``augmentations.py:504-525``); both orders are computed and the draw
    selects one, with the same contrast draw in both;
  * expand: p=1/2, canvas ratio U(1,4), uniform placement (``:408-440``);
  * random-sample-crop: 5/6 of the time, 50 candidate windows of size
    U(0.3,1) x the canvas with aspect in [0.5,2]; the first candidate that
    holds a non-crowd gt centre wins, else no crop (``:279-405``, the IoU
    constraint that the upstream bug makes a no-op left out);
  * gt whose centres leave the crop are dropped (labelled as padding), and
    so are degenerate boxes, as the reference's discard step does.

**Explicit draws.**  The random draws are an argument:
:func:`draw_augment` draws them from a ``torch.Generator`` in the domains
JAX's ``jax.random`` calls return (flags as bools, uniforms with their
range applied, the ``[B, 50]`` crop candidates, ``rot_k``), and
:func:`device_augment` is a deterministic function of the batch and the
draws: each image's output depends on its own rows alone.

Nothing here reads a device value on the host: per-image choices are
``torch.where`` selections, the first valid crop is an ``argmax``.

Deviation kept from JAX's module: the reference crops the image at its
original resolution and resizes once at the end; here images come
pre-resized to S x S, so crops resample an S x S source.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.config import MEANS, STD, MaskType, YolactConfig

CROP_CANDIDATES = 50


def _const(values, device) -> torch.Tensor:
    # non_blocking: a synchronous host-to-device copy would sync the host
    return torch.tensor(values, dtype=torch.float32).to(device,
                                                        non_blocking=True)


# ---------------------------------------------------------------------------
# color: BGR [0,255] <-> HSV (H in [0,360)), JAX's device formulas
# ---------------------------------------------------------------------------

def bgr_to_hsv(img: torch.Tensor) -> torch.Tensor:
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c > 0, c, 1.0)
    h = torch.where(
        v == r, (g - b) / safe_c,
        torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, h * 60.0, 0.0)
    h = torch.where(h < 0, h + 360.0, h)
    s = torch.where(v > 0, c / torch.where(v > 0, v, 1.0), 0.0)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_bgr(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = torch.clamp(h, 0.0, 360.0 - 1e-4) / 60.0
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.to(torch.int32) % 6

    def select(*values):
        out = values[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, values[k], out)
        return out

    r = select(v, q, p, p, t, v)
    g = select(t, v, v, q, p, p)
    b = select(p, p, t, v, v, q)
    return torch.stack([b, g, r], dim=-1)


def _per_image(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A [B] draw broadcast against a [B, ...] tensor of `ndim` dims."""
    return t.reshape((-1,) + (1,) * (ndim - 1))


def photometric_distort(img: torch.Tensor, draws: Dict) -> torch.Tensor:
    """img [B, S, S, 3] BGR float [0,255].  augmentations.py:504-525."""
    def c(name):
        return _per_image(draws[name], img.ndim)

    img = torch.where(c('brightness_on'), img + c('brightness'), img)

    def contrast(x):
        return torch.where(c('contrast_on'), x * c('contrast'), x)

    def hsv_jitter(x):
        hsv = bgr_to_hsv(x)
        s_mul = torch.where(draws['saturation_on'], draws['saturation'], 1.0)
        h_add = torch.where(draws['hue_on'], draws['hue'], 0.0)
        h = torch.remainder(hsv[..., 0] + _per_image(h_add, 3), 360.0)
        return hsv_to_bgr(torch.stack(
            [h, hsv[..., 1] * _per_image(s_mul, 3), hsv[..., 2]], dim=-1))

    img_a = hsv_jitter(contrast(img))       # contrast first
    img_b = contrast(hsv_jitter(img))       # contrast last
    return torch.where(c('contrast_first'), img_a, img_b)


# ---------------------------------------------------------------------------
# geometry: one affine (scale, translate) per axis, bilinear gather
# ---------------------------------------------------------------------------

def _axis_warp(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               dim: int, fill) -> torch.Tensor:
    """Sample each image of x [B, ...] along `dim` at src = scale * i +
    shift (scale, shift [B]; bilinear, `fill` outside)."""
    size = x.shape[dim]
    idx = torch.arange(size, dtype=torch.float32, device=x.device)
    src = scale[:, None] * idx + shift[:, None]             # [B, size]
    x0 = torch.floor(src)
    f = src - x0
    x0i = x0.to(torch.int64)
    valid0 = (x0i >= 0) & (x0i < size)
    valid1 = (x0i + 1 >= 0) & (x0i + 1 < size)
    c0 = x0i.clamp(0, size - 1)
    c1 = (x0i + 1).clamp(0, size - 1)
    shape = [x.shape[0]] + [1] * (x.ndim - 1)
    shape[dim] = size

    def take(index):
        return torch.gather(x, dim, index.reshape(shape).expand(x.shape))

    f = f.reshape(shape)
    return (torch.where(valid0.reshape(shape), take(c0), fill) * (1 - f)
            + torch.where(valid1.reshape(shape), take(c1), fill) * f)


def affine_warp_image(img, sx, tx, sy, ty, fill):
    """img [B, S, S, C]; fill [C] (the channel means)."""
    out = _axis_warp(img, sy, ty, 1, fill)
    return _axis_warp(out, sx, tx, 2, fill)


def affine_warp_masks(masks, sx, tx, sy, ty):
    """masks [B, G, S, S] float; zero fill; binarized by the caller."""
    out = _axis_warp(masks, sy, ty, 2, 0.0)
    return _axis_warp(out, sx, tx, 3, 0.0)


def _rot90(x: torch.Tensor, k: torch.Tensor, dims) -> torch.Tensor:
    """Each image of x [B, ...] turned ``k[b]`` quarter turns in the plane
    `dims` as ``torch.rot90`` / ``np.rot90`` turn it: k=1 transposes the
    width-flipped image, k=2 flips both axes, k=3 transposes the
    height-flipped one."""
    h, w = dims

    def where(flag, y):
        return torch.where(_per_image(flag, x.ndim), y, x)

    x = where((k == 1) | (k == 2), x.flip(w))
    x = where((k == 2) | (k == 3), x.flip(h))
    return where((k == 1) | (k == 3), x.transpose(h, w))


def draw_augment(cfg: YolactConfig, batch_size: int,
                 generator: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """The random draws of :func:`device_augment` for `batch_size` images,
    from `generator` (on its own device), moved to `device`: per image the
    Bernoulli(1/2) flags (bool), the uniforms with their range applied,
    ``crop_on`` (a uniform below 5/6), the ``[B, 50]`` crop candidates and
    ``rot_k`` in 0..3.  Every draw is made whatever `cfg` turns on, in one
    fixed order, so the generator moves on by the same amount."""
    gen_device = generator.device
    B, N = batch_size, CROP_CANDIDATES

    def uniform(lo, hi, *shape):
        u = torch.rand(shape or (B,), generator=generator, device=gen_device)
        return u * (hi - lo) + lo

    def flag():
        return uniform(0.0, 1.0) < 0.5

    draws = {}
    for name, lo, hi in (('brightness', -32.0, 32.0),
                         ('contrast', 0.5, 1.5),
                         ('saturation', 0.5, 1.5),
                         ('hue', -18.0, 18.0)):
        draws[name + '_on'] = flag()
        draws[name] = uniform(lo, hi)
    draws['contrast_first'] = flag()
    draws['expand_on'] = flag()
    draws['expand_ratio'] = uniform(1.0, 4.0)
    draws['expand_left'] = uniform(0.0, 1.0)
    draws['expand_top'] = uniform(0.0, 1.0)
    draws['crop_on'] = uniform(0.0, 1.0) < 5.0 / 6.0
    draws['crop_w'] = uniform(0.3, 1.0, B, N)
    draws['crop_h'] = uniform(0.3, 1.0, B, N)
    draws['crop_left'] = uniform(0.0, 1.0, B, N)
    draws['crop_top'] = uniform(0.0, 1.0, B, N)
    draws['mirror'] = flag()
    draws['flip'] = flag()
    draws['rot_k'] = torch.randint(0, 4, (B,), generator=generator,
                                   device=gen_device)
    return {k: v.to(device, non_blocking=True) for k, v in draws.items()}


def device_augment(cfg: YolactConfig, batch: Dict,
                   draws: Dict[str, torch.Tensor]) -> Dict:
    """Augment a padded batch (``data/coco.py:pad_batch``, tensors on one
    device) with the draws of :func:`draw_augment` (the batch's rows).

    ``batch['image']`` is RAW BGR [0,255] ``[B, S, S, 3]`` (uint8 or
    float; the loader only resized it) and ``gt_masks`` full resolution.
    Returns the batch with the image normalized to the backbone's input
    space and channel order (float32) and the gt moved with it, the same
    shapes; for lincomb configs that binarize the downsampled gt, the
    ``gt_masks_proto`` (and ``gt_masks_seg``) targets in place of
    ``gt_masks``: the soft warped masks resized, then thresholded at 0.5,
    the reference's order (multibox_loss.py:515-523, 225-228)."""
    image = batch['image'].float()
    B, S = image.shape[0], image.shape[1]
    dev = image.device
    mean = _const(MEANS, dev)
    boxes = batch['gt_boxes'].float()
    labels = batch['gt_labels']
    masks = batch['gt_masks'].float()
    zero = torch.zeros(B, device=dev)

    if cfg.augment_photometric_distort:
        image = photometric_distort(image, draws)

    # ---- expand (augmentations.py:408-440) -----------------------------
    if cfg.augment_expand:
        ratio = torch.where(draws['expand_on'], draws['expand_ratio'], 1.0)
        E = ratio * S
        left = draws['expand_left'] * (E - S)
        top = draws['expand_top'] * (E - S)
    else:
        E = torch.full((B,), float(S), device=dev)
        left = top = zero

    # gt in canvas pixels
    bx = boxes * S
    bx = bx + torch.stack([left, top, left, top], dim=-1)[:, None]

    # ---- random sample crop (augmentations.py:279-405) -----------------
    if cfg.augment_random_sample_crop:
        cw = draws['crop_w'] * E[:, None]                     # [B, N]
        ch = draws['crop_h'] * E[:, None]
        # the reference truncates the rect to ints
        cl = torch.floor(draws['crop_left'] * (E[:, None] - cw))
        ct = torch.floor(draws['crop_top'] * (E[:, None] - ch))
        cr = torch.floor(cl + cw)
        cb = torch.floor(ct + ch)
        aspect = ch / torch.clamp(cw, min=1e-6)
        ar_ok = (aspect >= 0.5) & (aspect <= 2.0)

        centers = (bx[..., :2] + bx[..., 2:]) / 2.0           # [B, G, 2]
        cx, cy = centers[:, None, :, 0], centers[:, None, :, 1]
        real = labels >= 0        # non-crowd, non-padding
        inside = ((cl[..., None] < cx) & (ct[..., None] < cy) &
                  (cr[..., None] > cx) & (cb[..., None] > cy))  # [B, N, G]
        has_gt = (inside & real[:, None]).any(dim=2)
        cand_ok = ar_ok & has_gt
        any_ok = cand_ok.any(dim=1) & draws['crop_on']
        pick = cand_ok.to(torch.uint8).argmax(dim=1, keepdim=True)  # first

        def at_pick(v):
            return torch.gather(v, 1, pick)[:, 0]

        wl = torch.where(any_ok, at_pick(cl), 0.0)
        wt = torch.where(any_ok, at_pick(ct), 0.0)
        ww = torch.where(any_ok, at_pick(cr) - at_pick(cl), E)
        wh = torch.where(any_ok, at_pick(cb) - at_pick(ct), E)

        # crowd-or-real gt kept iff its centre is inside the window
        cx, cy = centers[..., 0], centers[..., 1]
        keep_center = ((wl[:, None] < cx) & (wt[:, None] < cy) &
                       ((wl + ww)[:, None] > cx) & ((wt + wh)[:, None] > cy))
        keep = torch.where(any_ok[:, None], keep_center, labels > -2)
    else:
        wl = wt = zero
        ww = wh = E
        keep = labels > -2

    # clamp gt to the window, then into window-relative coords
    def clip(v, lo, span):
        lo, hi = lo[:, None], (lo + span)[:, None]
        return torch.minimum(torch.maximum(v, lo), hi) - lo

    bx = torch.stack([clip(bx[..., 0], wl, ww), clip(bx[..., 1], wt, wh),
                      clip(bx[..., 2], wl, ww), clip(bx[..., 3], wt, wh)],
                     dim=-1)

    # ---- mirror / vertical flip ----------------------------------------
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    do_mirror = draws['mirror'] if cfg.augment_random_mirror else false
    # RandomFlip + flip-gated RandomRot90 (augmentations.py:454-475; the
    # reference gates BOTH on augment_random_flip, a kept quirk)
    do_flip = draws['flip'] if cfg.augment_random_flip else false

    # ---- compose dst->src affine (half-pixel resize convention) --------
    sx = ww / S
    sy = wh / S
    # window coord -> original-image coord: subtract the expand offset
    tx = 0.5 * sx - 0.5 + (wl - left)
    ty = 0.5 * sy - 0.5 + (wt - top)
    # mirror/flip reverse the dst index before the map
    sx_m = torch.where(do_mirror, -sx, sx)
    tx_m = torch.where(do_mirror, tx + sx * (S - 1), tx)
    sy_m = torch.where(do_flip, -sy, sy)
    ty_m = torch.where(do_flip, ty + sy * (S - 1), ty)

    out_img = affine_warp_image(image, sx_m, tx_m, sy_m, ty_m, mean)
    out_masks = affine_warp_masks(masks, sx_m, tx_m, sy_m, ty_m)

    # boxes: window pixels -> output pixels -> normalized
    ob = bx / torch.stack([ww, wh, ww, wh], dim=-1)[:, None]
    x1, y1, x2, y2 = ob.unbind(-1)
    ob = torch.where(do_mirror[:, None, None],
                     torch.stack([1 - x2, y1, 1 - x1, y2], dim=-1), ob)
    x1, y1, x2, y2 = ob.unbind(-1)
    ob = torch.where(do_flip[:, None, None],
                     torch.stack([x1, 1 - y2, x2, 1 - y1], dim=-1), ob)

    # rot90 of the warped square output: the reference's rotate-before-
    # resize (per-axis scales commute with the axis swap on a square canvas)
    if cfg.augment_random_flip:
        k = draws['rot_k']
        out_img = _rot90(out_img, k, (1, 2))
        out_masks = _rot90(out_masks, k, (2, 3))
        turned = [ob]
        for _ in range(3):
            b = turned[-1].unbind(-1)
            turned.append(torch.stack([b[1], 1 - b[2], b[3], 1 - b[0]],
                                      dim=-1))
        for n in (1, 2, 3):
            ob = torch.where((k == n)[:, None, None], turned[n], ob)

    # discard degenerate boxes (augmentations.py:170-178: absolute width and
    # height at S must exceed cfg.discard_box_width / _height)
    wpx = (ob[..., 2] - ob[..., 0]) * S
    hpx = (ob[..., 3] - ob[..., 1]) * S
    keep = keep & (wpx > cfg.discard_box_width) & \
        (hpx > cfg.discard_box_height)
    new_labels = torch.where(keep, labels, -2)

    # normalize for the backbone (BackboneTransform)
    t = cfg.backbone.transform
    x = out_img
    if t.normalize:
        x = (x - mean) / _const(STD, dev)
    elif t.subtract_means:
        x = x - mean
    elif t.to_float:
        x = x / 255.0
    # permute from BGR to the backbone's channel order, as the host
    # backbone_transform (augmentations.py:584-588)
    x = torch.stack([x[..., 'BGR'.index(ch)] for ch in t.channel_order],
                    dim=-1)

    out = dict(batch, image=x, gt_boxes=ob, gt_labels=new_labels)
    if (cfg.mask_type == MaskType.LINCOMB
            and cfg.mask_proto_binarize_downsampled_gt):
        # the loss consumes the gt downsampled to proto (and seg)
        # resolution: soft downsample, then threshold, the reference's order
        from benchmark.reference.ops.anchors import proto_size, seg_size
        from benchmark.reference.ops.resize import resize_bilinear
        del out['gt_masks']
        out['gt_masks_proto'] = (resize_bilinear(
            out_masks, proto_size(cfg, S)) > 0.5).to(torch.uint8)
        if cfg.use_semantic_segmentation_loss:
            out['gt_masks_seg'] = (resize_bilinear(
                out_masks, seg_size(cfg, S)) > 0.5).to(torch.uint8)
    else:
        out['gt_masks'] = (out_masks > 0.5).to(torch.uint8)
    return out
