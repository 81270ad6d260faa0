"""The port's device augmentation (``yolact_tpu_torch/data/device_augment.py``)
against ``yolact_tpu/data/device_augment.py`` on the tiny configs (128²),
float32 on the CPU.

Both packages get the same uint8 image (``tests/test_device_augment.py``'s
``make_raw_batch``, rounded to uint8 as the loader's ``pack_images``
ships it) and the same draws: :func:`jax_augment_draws` repeats JAX's
``jax.random`` calls with ``device_augment``'s key splits and hands their
values to the port, whose ``device_augment`` draws nothing itself.

Tolerances: the HSV conversions within 1e-4 and the photometric distortion
within 1e-3 on the 0-255 scale; the augmented image within 1e-4 after
normalization; boxes within 1e-6; labels (the keep flags) and the affine
map of every image (scale and shift per axis, from the crop window and the
expand offset) exact.  Binary masks are exact, or each differing pixel is
witnessed: the same warp (and resize) in float64 puts it within 1e-6 of the
0.5 threshold, where float32 rounding decides the side.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_plus_config, tiny_resnet_config
from test_device_augment import make_raw_batch
from yolact_tpu.data import device_augment as DA
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.data import device_augment as TA

torch.set_num_threads(2)

# every stage alone (photometric distortion off) and all together
STAGES = {'expand': dict(augment_expand=True),
          'crop': dict(augment_random_sample_crop=True),
          'mirror': dict(augment_random_mirror=True),
          'flip': dict(augment_random_flip=True)}
ALL_OFF = dict(augment_photometric_distort=False, augment_expand=False,
               augment_random_sample_crop=False, augment_random_mirror=False,
               augment_random_flip=False)


def jax_augment_draws(rng, B):
    """The draws of JAX's ``device_augment(cfg, batch, rng)`` for `B` images,
    from its own key splits, as ``data/device_augment.py:draw_augment``'s
    dict of numpy arrays."""
    draws = _jax_draws_fn()(jax.random.split(rng, B))
    return {k: np.asarray(v) for k, v in draws.items()}


@functools.lru_cache(maxsize=None)
def _jax_draws_fn():
    u = jax.random.uniform
    bern = jax.random.bernoulli

    def per_image(k):
        ks = jax.random.split(k, 13)
        kp = jax.random.split(ks[0], 10)        # photometric_distort's
        return dict(
            brightness_on=bern(kp[0]),
            brightness=u(kp[1], (), minval=-32.0, maxval=32.0),
            contrast_on=bern(kp[2]),
            contrast=u(kp[3], (), minval=0.5, maxval=1.5),
            saturation_on=bern(kp[4]),
            saturation=u(kp[5], (), minval=0.5, maxval=1.5),
            hue_on=bern(kp[6]),
            hue=u(kp[7], (), minval=-18.0, maxval=18.0),
            contrast_first=bern(kp[8]),
            expand_on=bern(ks[1]),
            expand_ratio=u(ks[2], (), minval=1.0, maxval=4.0),
            expand_left=u(ks[3], (), maxval=1.0),
            expand_top=u(ks[4], (), maxval=1.0),
            crop_on=u(ks[5], ()) < (5.0 / 6.0),
            crop_w=u(ks[6], (TA.CROP_CANDIDATES,), minval=0.3, maxval=1.0),
            crop_h=u(ks[7], (TA.CROP_CANDIDATES,), minval=0.3, maxval=1.0),
            crop_left=u(ks[8], (TA.CROP_CANDIDATES,), maxval=1.0),
            crop_top=u(ks[9], (TA.CROP_CANDIDATES,), maxval=1.0),
            mirror=bern(ks[10]), flip=bern(ks[11]),
            rot_k=jax.random.randint(ks[12], (), 0, 4))

    return jax.jit(jax.vmap(per_image))


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def uint8_batch(cfg, seed=0, B=2):
    batch = make_raw_batch(np.random.RandomState(seed), cfg, B=B)
    batch['image'] = np.round(batch['image']).astype(np.uint8)
    return batch


def _seed_where(B, want):
    """The first key seed whose per-image draws satisfy `want(draws)` for
    every image."""
    for seed in range(2000):
        draws = jax_augment_draws(jax.random.PRNGKey(seed), B)
        if np.all(want(draws)):
            return seed
    raise AssertionError('no seed found')


def _capture_maps(monkeypatch):
    """Record the affine map (sx, tx, sy, ty) each package warps its images
    with: JAX's per image through a debug callback, the port's per batch."""
    maps = {'jax': [], 'port': []}
    jax_warp, port_warp = DA.affine_warp_image, TA.affine_warp_image

    def jax_spy(img, sx, tx, sy, ty, fill):
        jax.debug.callback(lambda *a: maps['jax'].append(
            np.stack([np.asarray(v, np.float32) for v in a], -1)),
            sx, tx, sy, ty)
        return jax_warp(img, sx, tx, sy, ty, fill)

    def port_spy(img, sx, tx, sy, ty, fill):
        maps['port'].append(torch.stack([sx, tx, sy, ty], -1).numpy())
        return port_warp(img, sx, tx, sy, ty, fill)

    monkeypatch.setattr(DA, 'affine_warp_image', jax_spy)
    monkeypatch.setattr(TA, 'affine_warp_image', port_spy)
    return maps


def _warp64(x, sx, tx, sy, ty):
    """The separable bilinear warp of one image's masks [G, S, S] in
    float64, zero fill (``_axis_warp`` of both packages)."""
    def axis(x, scale, shift, ax):
        n = x.shape[ax]
        src = np.float64(scale) * np.arange(n) + np.float64(shift)
        x0 = np.floor(src).astype(np.int64)
        f = src - x0
        shape = [1] * x.ndim
        shape[ax] = n
        out = 0
        for c, w in ((x0, 1 - f), (x0 + 1, f)):
            ok = ((c >= 0) & (c < n)).reshape(shape)
            g = np.take(x, np.clip(c, 0, n - 1), axis=ax)
            out = out + np.where(ok, g, 0.0) * w.reshape(shape)
        return out
    return axis(axis(np.asarray(x, np.float64), sy, ty, 1), sx, tx, 2)


def _rot64(x, k):
    return np.rot90(x, k, axes=(1, 2))


def _assert_masks_witnessed(got, want, soft64, what):
    """Binary masks equal, or each differing pixel's float64 value within
    1e-6 of 0.5."""
    diff = got != want
    if diff.any():
        gap = np.abs(soft64[diff] - 0.5)
        assert gap.max() <= 1e-6, (what, int(diff.sum()), gap.max())
    assert diff.mean() < 1e-3, (what, int(diff.sum()))


def _run_both(jcfg, batch, rng, monkeypatch=None):
    """(JAX's output, the port's, the draws, the captured affine maps).
    With `monkeypatch` the maps are captured and JAX runs op by op: jit
    fuses some of its float32 arithmetic (one ulp in a shift)."""
    maps = None if monkeypatch is None else _capture_maps(monkeypatch)
    augment = lambda b, r: DA.device_augment(jcfg, b, r)       # noqa: E731
    want = (augment if maps else jax.jit(augment))(batch, rng)
    draws = jax_augment_draws(rng, len(batch['image']))
    got = TA.device_augment(P(jcfg), _torch(batch), _torch(draws))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, draws, maps)


# ---- colour ----------------------------------------------------------------

def test_hsv_both_ways_match_jax():
    rng = np.random.RandomState(0)
    img = (rng.rand(4, 16, 16, 3) * 255).astype(np.float32)
    img[0, :4] = img[0, :4, :, :1]              # grey pixels: c == 0
    img[1, :4, :, 1] = img[1, :4, :, 2]          # ties between channels
    img[2, :2] = 0.0
    hsv = TA.bgr_to_hsv(torch.from_numpy(img)).numpy()
    want = np.asarray(DA.bgr_to_hsv(jnp.asarray(img)))
    np.testing.assert_allclose(hsv, want, rtol=0, atol=1e-4)
    hsv[..., 0] = rng.rand(4, 16, 16) * 360       # every sector
    back = TA.hsv_to_bgr(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(back, np.asarray(DA.hsv_to_bgr(
        jnp.asarray(hsv))), rtol=0, atol=1e-4)


@pytest.mark.parametrize('first', [True, False],
                         ids=['contrast_first', 'contrast_last'])
def test_photometric_distort_matches_jax(first):
    """Each image with its order of contrast and HSV jitter, every other
    flag as drawn: within 1e-3 on the 0-255 scale."""
    B = 6
    seed = _seed_where(B, lambda d: d['contrast_first'] == first)
    rng = jax.random.PRNGKey(seed)
    draws = jax_augment_draws(rng, B)
    assert draws['contrast_on'].any() and draws['saturation_on'].any()
    img = np.round(np.random.RandomState(1).rand(B, 24, 24, 3) * 255)\
        .astype(np.float32)
    keys = jax.vmap(lambda k: jax.random.split(k, 13)[0])(
        jax.random.split(rng, B))
    want = np.asarray(jax.vmap(DA.photometric_distort)(keys,
                                                       jnp.asarray(img)))
    got = TA.photometric_distort(torch.from_numpy(img), _torch(draws))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


# ---- the warp --------------------------------------------------------------

def _warp_case(stage):
    """(JAX config with full-resolution mask output, key seed): every stage
    on, or one stage alone; 'flip<k>' has every image flipped and turned k
    quarter turns."""
    if stage == 'all':
        return tiny_resnet_config(augment_random_flip=True,
                                  mask_proto_binarize_downsampled_gt=False), 3
    name = 'flip' if stage.startswith('flip') else stage
    cfg = tiny_resnet_config(mask_proto_binarize_downsampled_gt=False,
                             **dict(ALL_OFF, **STAGES[name]))
    if name == 'flip':
        k = int(stage[4:])
        return cfg, _seed_where(2, lambda d: d['flip'] & (d['rot_k'] == k))
    flag = {'expand': 'expand_on', 'crop': 'crop_on', 'mirror': 'mirror'}
    return cfg, _seed_where(2, lambda d: d[flag[name]])


@pytest.mark.parametrize('stage', ['all', 'expand', 'crop', 'mirror', 'flip0',
                                   'flip1', 'flip2', 'flip3'])
def test_warp_matches_jax(stage, monkeypatch):
    jcfg, seed = _warp_case(stage)
    batch = uint8_batch(jcfg, seed=seed)
    want, got, draws, maps = _run_both(jcfg, batch, jax.random.PRNGKey(seed),
                                       monkeypatch)
    (port_maps,) = maps['port']
    np.testing.assert_array_equal(port_maps, np.stack(maps['jax']))
    if stage != 'all':          # the stage changed the map or the turn
        identity = np.array([1, 0, 1, 0], np.float32)
        assert stage.startswith('flip') or \
            (port_maps != identity).any(axis=1).all()
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got['image'], want['image'], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got['gt_boxes'], want['gt_boxes'], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got['gt_labels'], want['gt_labels'])
    for k in ('num_gts', 'num_crowds'):
        np.testing.assert_array_equal(got[k], want[k])
    k = draws['rot_k'] if jcfg.augment_random_flip else np.zeros(2, int)
    for b in range(2):
        soft = _rot64(_warp64(batch['gt_masks'][b], *port_maps[b]), k[b])
        _assert_masks_witnessed(got['gt_masks'][b], want['gt_masks'][b],
                                soft, (stage, b))
        _assert_masks_witnessed(got['gt_masks'][b], soft > 0.5, soft,
                                (stage, b, 'float64'))


@pytest.mark.parametrize('make_cfg', [tiny_resnet_config, tiny_plus_config],
                         ids=['base', 'plus'])
def test_multires_targets_match_jax(make_cfg, monkeypatch):
    """``emit_multires``: the soft warped masks resized to the proto (and
    seg) size, then thresholded: JAX's targets, each differing pixel
    witnessed by a float64 warp and resize."""
    from yolact_tpu.ops.resize import _weights
    jcfg = make_cfg(augment_random_flip=True)
    assert jcfg.mask_proto_binarize_downsampled_gt
    seed = 5
    batch = uint8_batch(jcfg, seed=seed, B=3)
    maps = _capture_maps(monkeypatch)
    want, got, draws, _ = _run_both(jcfg, batch, jax.random.PRNGKey(seed))
    names = ['gt_masks_proto'] + (
        ['gt_masks_seg'] if jcfg.use_semantic_segmentation_loss else [])
    assert sorted(k for k in got if k.startswith('gt_masks')) == sorted(names)
    (port_maps,) = maps['port']
    for b in range(3):
        soft = _rot64(_warp64(batch['gt_masks'][b], *port_maps[b]),
                      draws['rot_k'][b])
        for name in names:
            h, w = want[name].shape[-2:]
            small = np.einsum('oh,ghw,pw->gop',
                              _weights(soft.shape[1], h).astype(np.float64),
                              soft, _weights(soft.shape[2], w)
                              .astype(np.float64))
            _assert_masks_witnessed(got[name][b], want[name][b], small,
                                    (name, b))
    assert got['gt_masks_proto'].any()


# ---- the port alone (tests/test_device_augment.py's cases) -----------------

def _port_augment(cfg, batch, seed):
    draws = TA.draw_augment(cfg, len(batch['image']),
                            torch.Generator().manual_seed(seed), 'cpu')
    out = TA.device_augment(cfg, _torch(batch), draws)
    return {k: v.numpy() for k, v in out.items()}


def test_identity_when_disabled():
    """Every flag off: the normalized input, the same boxes, masks and
    labels."""
    from yolact_tpu_torch.data.augmentations import backbone_transform
    cfg = P(tiny_resnet_config(mask_proto_binarize_downsampled_gt=False,
                               **ALL_OFF))
    batch = uint8_batch(cfg, seed=0)
    out = _port_augment(cfg, batch, 0)
    want = np.stack([backbone_transform(cfg, im) for im in batch['image']])
    np.testing.assert_allclose(out['image'], want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out['gt_boxes'], batch['gt_boxes'], atol=1e-6)
    np.testing.assert_array_equal(out['gt_masks'], batch['gt_masks'])
    np.testing.assert_array_equal(out['gt_labels'], batch['gt_labels'])


def _mask_box_iou(mask, box, S):
    ys, xs = np.where(mask)
    mb = np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]) / S
    ix = max(0, min(mb[2], box[2]) - max(mb[0], box[0]))
    iy = max(0, min(mb[3], box[3]) - max(mb[1], box[1]))
    inter = ix * iy
    return inter / ((mb[2] - mb[0]) * (mb[3] - mb[1])
                    + (box[2] - box[0]) * (box[3] - box[1]) - inter)


@pytest.mark.parametrize('flip_only', [False, True],
                         ids=['every_stage', 'flip_and_rot90'])
def test_boxes_and_masks_stay_aligned(flip_only):
    """For every kept gt over 6 seeds, the warped mask's extent agrees with
    the moved box (IoU > 0.5), and the transforms fire."""
    overrides = dict(ALL_OFF, augment_random_flip=True) if flip_only else \
        dict(augment_photometric_distort=False, augment_random_flip=True)
    cfg = P(tiny_resnet_config(mask_proto_binarize_downsampled_gt=False,
                               **overrides))
    batch = uint8_batch(cfg, seed=1, B=4)
    S, moved = cfg.max_size, 0
    for seed in range(6):
        out = _port_augment(cfg, batch, seed)
        moved += not np.allclose(out['gt_boxes'], batch['gt_boxes'],
                                 atol=1e-5)
        for b in range(4):
            for g in range(out['gt_boxes'].shape[1]):
                m = out['gt_masks'][b, g]
                if out['gt_labels'][b, g] < 0 or m.sum() < 12:
                    continue
                assert _mask_box_iou(m, out['gt_boxes'][b, g], S) > 0.5, \
                    (seed, b, g)
    assert moved >= 4


def test_rot90_turns_as_numpy():
    """``_rot90`` with a k per image equals ``np.rot90`` of each image on an
    image asymmetric in both axes, and the box turn follows it."""
    x = torch.arange(4 * 5 * 5 * 2, dtype=torch.float32).reshape(4, 5, 5, 2)
    x[:, 0, 1] += 1000              # asymmetric in both axes
    k = torch.tensor([0, 1, 2, 3])
    got = TA._rot90(x, k, (1, 2)).numpy()
    for b in range(4):
        np.testing.assert_array_equal(
            got[b], np.rot90(x[b].numpy(), b, axes=(0, 1)))
    np.testing.assert_array_equal(
        np.asarray(jnp.rot90(jnp.asarray(x[1].numpy()), 1, axes=(0, 1))),
        got[1])


def test_rank_rows_equal_the_whole_batch_rows():
    """The augmentation is per image: a data-parallel rank's rows of the
    batch and of the draws give those rows of the whole batch's output,
    bit for bit."""
    from yolact_tpu_torch.parallel.mesh import shard_batch
    cfg = P(tiny_plus_config(augment_random_flip=True))
    batch = _torch(uint8_batch(cfg, seed=2, B=4))
    draws = TA.draw_augment(cfg, 4, torch.Generator().manual_seed(3), 'cpu')
    whole = TA.device_augment(cfg, batch, draws)
    for rank in range(2):
        part = TA.device_augment(cfg, shard_batch(batch, rank, 2),
                                 shard_batch(draws, rank, 2))
        rows = shard_batch(whole, rank, 2)
        assert part.keys() == rows.keys()
        for k in part:
            assert torch.equal(part[k], rows[k]), (rank, k)


def test_draws_are_seeded_and_in_their_domains():
    cfg = P(tiny_resnet_config())
    a, b = (TA.draw_augment(cfg, 64, torch.Generator().manual_seed(0), 'cpu')
            for _ in range(2))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    ranges = dict(brightness=(-32, 32), contrast=(0.5, 1.5),
                  saturation=(0.5, 1.5), hue=(-18, 18), expand_ratio=(1, 4),
                  expand_left=(0, 1), expand_top=(0, 1), crop_w=(0.3, 1),
                  crop_h=(0.3, 1), crop_left=(0, 1), crop_top=(0, 1))
    for k, (lo, hi) in ranges.items():
        assert a[k].dtype == torch.float32
        assert float(a[k].min()) >= lo and float(a[k].max()) < hi, k
    assert a['crop_w'].shape == (64, TA.CROP_CANDIDATES)
    assert set(a['rot_k'].tolist()) == {0, 1, 2, 3}
    for k in ('mirror', 'flip', 'crop_on', 'expand_on', 'contrast_first'):
        assert a[k].dtype == torch.bool and 0 < int(a[k].sum()) < 64, k


# ---- one train step ---------------------------------------------------------

def test_train_step_with_device_augment_matches_jax(monkeypatch):
    """One ``use_device_augment`` step (the s2d stem, frozen batch norm)
    from the same weights, uint8 batch and draws (JAX's step splits its key
    into the loss's and the augmentation's): each loss letter within 1e-4
    relative of JAX's step, and the augmented batch JAX's.

    The gradients are held on one augmented batch, the port's: JAX's step
    without device augmentation on it, every momentum buffer within 1e-3
    of its largest entry as ``tests/test_torch_train.py`` holds the step,
    and a float64 run of the port's step on it within 1e-4 (batch seed 0
    has no ReLU input within rounding of zero there).  JAX's jitted
    augmentation fuses its arithmetic, so its image lies within float32
    rounding of the port's but not on it, and on this batch that moves a
    ReLU input across zero: the gradients of JAX's device-augment step lie
    up to 1.2e-1 of a tensor's largest entry from both (found in the
    semantic-segmentation conv's bias), as one sign flip moves them in
    ``tests/test_torch_train.py``."""
    from test_torch_loss import jax_draws
    from test_torch_train import (_float64_grads, _jax_state, _leaves,
                                  _numpy, _port_state)
    from yolact_tpu.train.step import train_step as jax_train_step
    from yolact_tpu_torch.convert.from_jax import state_dict_to_train_state
    from yolact_tpu_torch.train.step import (apply_gradients,
                                             batch_to_device,
                                             loss_and_grads, prepare_batch)
    jcfg = tiny_resnet_config(use_device_augment=True, freeze_bn=True,
                              augment_random_flip=True, stem_s2d=True)
    plain = jcfg.copy(use_device_augment=False)
    model, jstate = _jax_state(jcfg)
    batch = uint8_batch(jcfg, seed=0)
    key = jax.random.PRNGKey(7)
    loss_key, aug_key = jax.random.split(key)
    _, jlosses = jax.jit(
        lambda s, b, r: jax_train_step(jcfg, model, s, b, r))(jstate, batch,
                                                             key)
    jbatch = {k: np.asarray(v) for k, v in jax.jit(
        lambda b, r: DA.device_augment(jcfg, b, r))(batch, aug_key).items()}
    p = 3 * sum((128 // s) ** 2 for s in (8, 16, 32, 64, 128))
    draws = [torch.from_numpy(a.copy())
             for a in jax_draws(loss_key, 2, p, jcfg.masks_to_train)]
    aug = _torch(jax_augment_draws(aug_key, 2))
    augmented = {k: v.numpy() for k, v in prepare_batch(
        P(jcfg), batch_to_device(batch, 'cpu'), aug).items()}
    assert augmented.keys() == jbatch.keys()
    np.testing.assert_allclose(augmented['image'], jbatch['image'], rtol=0,
                               atol=1e-4)
    for k in ('gt_masks_proto', 'gt_masks_seg'):
        assert (augmented[k] != jbatch[k]).mean() < 1e-3, k
    for k in ('gt_boxes', 'gt_labels', 'num_gts', 'num_crowds'):
        np.testing.assert_allclose(augmented[k], jbatch[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    jnew, plain_losses = jax.jit(
        lambda s, b, r: jax_train_step(plain, model, s, b, r))(
            jstate, augmented, loss_key)

    state = _port_state(jcfg, jstate)
    losses = apply_gradients(state, loss_and_grads(state, batch, *draws,
                                                   augment_draws=aug))
    assert losses['finite'] and set(losses) - {'finite'} == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(float(losses[k]), float(plain_losses[k]),
                                   rtol=1e-4, err_msg=k)
    old = _numpy(jstate.params), _numpy(jstate.batch_stats)
    bufs = {k: state.optimizer.state[p]['momentum_buffer']
            for k, p in state.model.named_parameters() if p.requires_grad}
    got = {k: v for k, v in _leaves(state_dict_to_train_state(
        bufs, *old)[0]).items() if v is not None}
    want = _leaves(jnew.opt_state[1].trace)
    assert got.keys() <= want.keys() and len(got) > 10
    for name, g in got.items():
        tol = max(np.abs(want[name]).max(), 1e-6) * 1e-3
        np.testing.assert_allclose(g, want[name], rtol=0, atol=tol,
                                   err_msg=name)
    ref = _float64_grads(plain, jstate, augmented, draws, monkeypatch)
    grads = {k: p.grad for k, p in state.model.named_parameters()
             if p.grad is not None}
    assert grads.keys() == ref.keys()
    for k, g in grads.items():
        err = float((g - ref[k]).abs().max() /
                    ref[k].abs().max().clamp(min=1e-12))
        assert err < 1e-4, (k, err)


@pytest.mark.parametrize('size', [((550, 550), (138, 138)),
                                  ((128, 96), (16, 40)),
                                  ((70, 90), (90, 70)),
                                  ((33, 100), (100, 33))],
                         ids=['550_to_138', 'down', 'mixed', 'up_and_down'])
def test_resizes_match_jax(size):
    """``ops/resize.py``: the host resize bit for bit JAX's numpy products
    (two taps a pass, the other terms exact zeros), and the tensor resize
    (the two products, ``torch.matmul``) within 1e-6 of JAX's on the
    device path."""
    from yolact_tpu.ops.resize import (resize_bilinear_torch,
                                       resize_bilinear_torch_np)
    from yolact_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_np
    (hi, wi), out = size
    x = np.random.RandomState(hi).rand(3, hi, wi).astype(np.float32)
    np.testing.assert_array_equal(resize_bilinear_np(x, out),
                                  resize_bilinear_torch_np(x, out))
    got = resize_bilinear(torch.from_numpy(x), out).numpy()
    np.testing.assert_allclose(got, np.asarray(resize_bilinear_torch(
        jnp.asarray(x), out)), rtol=0, atol=1e-6)
