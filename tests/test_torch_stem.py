"""The port's space-to-depth stem (yolact_tpu_torch.models.layers s2d
helpers, kernels/stem.py, ResNetBackbone(stem_s2d), infer's s2d
preprocess) against the JAX package, on the CPU.

Tolerances: the weight derivation and the rearrangements are exact (equal
arrays); the s2d preprocess within 1e-5 (JAX folds 1/std into its one-hot
conv, the port divides after subtracting); the plain stem conv within
1e-5 in float32 and within JAX's own bfloat16 bound (0.05 absolute on
inputs scaled by 0.1, tests/test_stem_kernel.py); the tiny s2d forward
within 1e-4 (float32 convolutions summed in another order); pipelines as
tests/test_torch_pipeline.py (classes and validity identical, scores and
boxes within 1e-5, masks within 1e-4).  The port gets its own config
(``P`` = ``config_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import tiny_darknet_config, tiny_resnet_config
from yolact_tpu.config import MEANS, STD, TransformConfig
from yolact_tpu.infer import Pipeline as JaxPipeline
from yolact_tpu.infer import _prepare_input as jax_prepare_input
from yolact_tpu.infer import maybe_enable_stem_s2d as jax_maybe_enable
from yolact_tpu.infer import preprocess_device_s2d as jax_preprocess_s2d
from yolact_tpu.infer import random_variables
from yolact_tpu.kernels.stem import _conv_xla, stem_conv_s2d_pallas
from yolact_tpu.models import layers as jax_layers
from yolact_tpu.models.yolact import Yolact as JaxYolact
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import jax_variables_to_state_dict
from yolact_tpu_torch.infer import (Pipeline, maybe_enable_stem_s2d,
                                    preprocess_device, preprocess_device_s2d,
                                    random_state_dict)
from yolact_tpu_torch.kernels import stem
from yolact_tpu_torch.models.layers import s2d_input, s2d_stem_kernel
from yolact_tpu_torch.models.resnet import ResNetBackbone
from yolact_tpu_torch.models.yolact import Yolact

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def jax_vars():
    """Seeded JAX variables of the tiny ResNet config; the s2d stem has
    the same parameters, so one tree serves both stems."""
    v = jax.tree_util.tree_map(
        np.array, random_variables(tiny_resnet_config(), seed=3))
    return {'params': v['params'], 'batch_stats': v['batch_stats']}


def _copy(tree):
    return jax.tree_util.tree_map(np.copy, tree)


def _frames(batch=2, size=128, seed=11):
    return np.random.RandomState(seed).randint(
        0, 256, (batch, size, size, 3)).astype(np.float32)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize('cin,cout,seed', [(3, 64, 0), (3, 8, 1), (1, 4, 2)])
def test_s2d_stem_kernel_matches_jax(cin, cout, seed):
    w = np.random.RandomState(seed).randn(7, 7, cin, cout).astype(np.float32)
    want = np.asarray(jax_layers.s2d_stem_kernel(jnp.asarray(w)))
    got = s2d_stem_kernel(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    assert tuple(got.shape) == (cout, 4 * cin, 4, 4)
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))


def test_s2d_stem_kernel_rejects_other_kernels():
    with pytest.raises(NotImplementedError):
        s2d_stem_kernel(torch.zeros(64, 3, 3, 3))


@pytest.mark.parametrize('from_rgb', [False, True])
def test_s2d_input_matches_jax(from_rgb):
    img = np.random.RandomState(3).randn(2, 10, 6, 3).astype(np.float32)
    want = jax_layers.s2d_input(jnp.asarray(img), from_rgb=from_rgb)
    got = s2d_input(torch.from_numpy(img).permute(0, 3, 1, 2),
                    from_rgb=from_rgb)
    np.testing.assert_array_equal(got.numpy(), _nchw(want))
    # channel (p*2+q)*3 + c: the pixel at row p, column q of each cell
    c_raw = 2 if from_rgb else 0
    np.testing.assert_array_equal(got[:, 3 + c_raw].numpy(),
                                  img[:, 0::2, 1::2, 0])
    with pytest.raises(ValueError):
        s2d_input(torch.zeros(1, 3, 5, 4))


@pytest.mark.parametrize('transform', [
    dict(normalize=True),
    dict(normalize=False, subtract_means=True),
    dict(normalize=False, to_float=True),
], ids=['normalize', 'subtract_means', 'to_float'])
def test_preprocess_device_s2d_matches_jax(transform):
    cfg = tiny_resnet_config()
    cfg = cfg.copy(backbone=cfg.backbone.copy(
        transform=TransformConfig(**transform)))
    frames = _frames()
    want = jax_preprocess_s2d(cfg, jnp.asarray(frames))
    got = preprocess_device_s2d(P(cfg), torch.from_numpy(frames))
    assert tuple(got.shape) == (2, 12, 64, 64)
    np.testing.assert_allclose(got.numpy(), _nchw(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize('overrides', [{'max_size': 127},
                                       {'preserve_aspect_ratio': True}],
                         ids=['odd_max_size', 'preserve_aspect_ratio'])
def test_preprocess_device_s2d_rejects_like_jax(overrides):
    cfg = tiny_resnet_config().copy(**overrides)
    frames = _frames(1, 64)
    with pytest.raises(ValueError):
        jax_preprocess_s2d(cfg, jnp.asarray(frames))
    with pytest.raises(ValueError):
        preprocess_device_s2d(P(cfg), torch.from_numpy(frames))


def test_non_resnet_stem_s2d_raises_like_jax():
    cfg = tiny_darknet_config(stem_s2d=True)
    with pytest.raises(ValueError, match='ResNet'):
        jax.eval_shape(lambda: JaxYolact(cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 12))))
    with pytest.raises(ValueError, match='ResNet'):
        Yolact(P(cfg))


def test_s2d_without_protonet_source_raises_like_jax():
    cfg = tiny_resnet_config(stem_s2d=True, mask_proto_src=None)
    with pytest.raises(ValueError, match='mask_proto_src'):
        jax.eval_shape(lambda: JaxYolact(cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 12))))
    with pytest.raises(ValueError, match='mask_proto_src'):
        Yolact(P(cfg))


@pytest.mark.parametrize('overrides', [
    {}, {'preserve_aspect_ratio': True}, {'max_size': 127},
    {'mask_proto_src': None}])
def test_maybe_enable_stem_s2d_matches_jax(overrides):
    cfg = tiny_resnet_config().copy(**overrides)
    assert maybe_enable_stem_s2d(P(cfg)).stem_s2d == \
        jax_maybe_enable(cfg).stem_s2d
    assert maybe_enable_stem_s2d(P(cfg)).stem_s2d == (not overrides)


@pytest.mark.parametrize('shape,cout', [
    ((2, 12, 64, 64), 64),
    ((1, 12, 37, 37), 16),     # h not a multiple of the Pallas row block
    ((2, 12, 37, 41), 64),
])
def test_stem_conv_plain_matches_jax_f32(shape, cout):
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 0.1).astype(np.float32)
    w2 = (rng.randn(cout, 12, 4, 4) * 0.1).astype(np.float32)
    xj, wj = jnp.asarray(x.transpose(0, 2, 3, 1)), \
        jnp.asarray(w2.transpose(2, 3, 1, 0))
    got = stem.stem_conv_s2d_plain(torch.from_numpy(x),
                                   torch.from_numpy(w2)).numpy()
    for want in (_conv_xla(xj, wj),
                 stem_conv_s2d_pallas(xj, wj, interpret=True)):
        np.testing.assert_allclose(got, _nchw(want), rtol=1e-5, atol=1e-5)


def test_stem_conv_plain_matches_jax_bf16():
    rng = np.random.RandomState(4)
    x = (rng.randn(1, 12, 37, 40) * 0.1).astype(np.float32)
    w2 = (rng.randn(64, 12, 4, 4) * 0.1).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16)
    wj = jnp.asarray(w2.transpose(2, 3, 1, 0), jnp.bfloat16)
    got = stem.stem_conv_s2d_plain(torch.from_numpy(x).bfloat16(),
                                   torch.from_numpy(w2).bfloat16())
    assert got.dtype == torch.bfloat16
    for want in (_conv_xla(xj, wj),
                 stem_conv_s2d_pallas(xj, wj, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   _nchw(np.asarray(want, np.float32)),
                                   rtol=0, atol=0.05)


def test_stem_conv_on_cpu_is_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 12, 9, 7, generator=gen)
    w2 = torch.randn(64, 12, 4, 4, generator=gen)
    n0 = stem.launches
    assert torch.equal(stem.stem_conv_s2d(x, w2),
                       stem.stem_conv_s2d_plain(x, w2))
    assert stem.launches == n0


def test_tiny_s2d_forward_matches_jax_and_plain_stem(jax_vars):
    """Yolact(cfg.copy(stem_s2d=True)) runs the s2d stem on a half-size
    12-channel input (the port once ignored the flag and built the 7x7
    stem) and matches JAX's s2d model and the port's plain stem on the
    same weights, priors at the logical image size included."""
    cfg = tiny_resnet_config(stem_s2d=True)
    v = jax_vars
    sd = jax_variables_to_state_dict(P(cfg), v)
    frames = _frames()
    want = jax.jit(lambda v, x: JaxYolact(cfg).apply(v, x, train=False))(
        v, jax_preprocess_s2d(cfg, jnp.asarray(frames)))
    model = Yolact(P(cfg)).eval()
    model.load_state_dict(sd)
    assert model.backbone.stem_s2d
    x = preprocess_device_s2d(P(cfg), torch.from_numpy(frames))
    with torch.no_grad():
        got = model(x)
    assert x.shape[1:] == (12, 64, 64)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)

    plain = Yolact(P(cfg).copy(stem_s2d=False)).eval()
    plain.load_state_dict(sd)
    with torch.no_grad():
        ref = plain(preprocess_device(P(cfg), torch.from_numpy(frames)))
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_s2d_weight_follows_reloads_and_casts():
    """The derived 4x4 weight is cached but never stale: a reload of the
    state dict or a dtype cast of conv1 rebuilds it."""
    bb = ResNetBackbone((1, 1, 1, 1), stem_s2d=True)
    with torch.no_grad():
        first = bb.s2d_weight()
        assert bb.s2d_weight() is first               # cached
    # under grad mode it is part of the graph, derived anew each time
    live = bb.s2d_weight()
    assert live.requires_grad and bb.s2d_weight() is not live
    assert torch.equal(live, first)
    w = torch.randn(64, 3, 7, 7, generator=torch.Generator().manual_seed(1))
    bb.load_state_dict(dict(bb.state_dict(), **{'conv1.weight': w}))
    with torch.no_grad():
        assert torch.equal(bb.s2d_weight(), s2d_stem_kernel(w))
        bb.conv1.to(torch.bfloat16)
        got = bb.s2d_weight()
    assert got.dtype == torch.bfloat16 and not got.requires_grad
    assert torch.equal(got, s2d_stem_kernel(w).bfloat16())
    bb.conv1 = torch.nn.Conv2d(3, 64, 7, stride=1, padding=3, bias=False)
    with pytest.raises(NotImplementedError):
        bb.s2d_weight()


@pytest.mark.parametrize('sparse', [True, False])
def test_s2d_pipeline_matches_jax_pipeline(jax_vars, sparse):
    """Raw frames: both Pipelines turn the s2d stem on by themselves (a
    config that asks for it gets the same)."""
    cfg = tiny_resnet_config(nms_candidates=256)
    v = _copy(jax_vars)
    if sparse:
        head = v['params']['prediction_layers_0']['conf_layer']['conv']
        b = np.array(head['bias']).reshape(-1, cfg.num_classes)
        b[:, 0] += 3.0
        head['bias'] = b.reshape(-1)
    frames = _frames(seed=7)
    want = JaxPipeline(cfg, v)(frames)
    assert JaxPipeline(cfg, v).cfg.stem_s2d
    sd = jax_variables_to_state_dict(P(cfg), v)
    pipe = Pipeline(P(cfg), sd, 'cpu')
    assert pipe.cfg.stem_s2d and pipe.model.backbone.stem_s2d
    n0 = stem.launches
    got = pipe(frames)
    assert stem.launches == n0            # CPU tensors: the plain version
    assert bool(got.valid.any())
    _assert_match(want, got)
    asked = Pipeline(P(cfg).copy(stem_s2d=True), sd, 'cpu')(frames)
    for name in ('valid', 'classes', 'scores', 'boxes', 'masks'):
        assert torch.equal(getattr(asked, name), getattr(got, name))


@pytest.mark.parametrize('stem_s2d', [False, True])
def test_pipeline_normalized_input_matches_jax(jax_vars, stem_s2d):
    """preprocess=False: host-normalized [B, S, S, 3] RGB frames (the eval
    loop's input), through JAX's _prepare_input rule."""
    cfg = tiny_resnet_config(stem_s2d=stem_s2d)
    v = jax_vars
    imgs = ((_frames(seed=8) - np.float32(MEANS)) / np.float32(STD))[
        ..., ::-1].copy()
    assert jax_prepare_input(cfg, jnp.asarray(imgs), False).shape == (
        (2, 64, 64, 12) if stem_s2d else (2, 128, 128, 3))
    want = JaxPipeline(cfg, v, preprocess=False)(imgs)
    got = Pipeline(P(cfg), jax_variables_to_state_dict(P(cfg), v), 'cpu',
                   preprocess=False)(imgs)
    _assert_match(want, got)


def test_s2d_pipeline_bf16_runs_on_random_weights():
    cfg = tiny_resnet_config(stem_s2d=True)
    sd = random_state_dict(P(cfg), torch.Generator().manual_seed(0))
    out = Pipeline(P(cfg), sd, 'cpu', 'bfloat16')(_frames(1))
    assert out.masks.shape == (1, cfg.max_num_detections, 32, 32)
    assert all(bool(torch.isfinite(t).all())
               for t in (out.boxes, out.scores, out.masks))


def _assert_match(want, got):
    np.testing.assert_array_equal(np.asarray(want.valid), got.valid.numpy())
    np.testing.assert_array_equal(np.asarray(want.classes),
                                  got.classes.numpy())
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.masks.numpy(), np.asarray(want.masks),
                               rtol=0, atol=1e-4)


# ---- gradients ------------------------------------------------------------

def test_stem_conv_grads_match_jax(rng):
    """The stem conv's gradients in x and w2 (kernels/stem.py:
    stem_conv_s2d_grads, what the kernel's autograd.Function returns on the
    card, and autograd through the plain version on the CPU) against
    jax.grad through JAX's stem_conv_s2d, whose forward runs as its own
    tests run it on the CPU (XLA conv; Pallas interpret for the forward
    check), within 1e-5 of each gradient's largest entry."""
    x = rng.randn(2, 9, 11, 12).astype(np.float32)
    w2 = (rng.randn(4, 4, 12, 64) * 0.1).astype(np.float32)
    g = rng.randn(2, 9, 11, 64).astype(np.float32)
    from yolact_tpu.kernels.stem import stem_conv_s2d as jax_stem
    want = jax.grad(lambda a, b: jnp.sum(jax_stem(a, b) * jnp.asarray(g)),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w2))
    want = (_nchw(want[0]), np.asarray(want[1]).transpose(3, 2, 0, 1))
    np.testing.assert_allclose(
        np.asarray(stem_conv_s2d_pallas(jnp.asarray(x), jnp.asarray(w2),
                                        interpret=True)),
        np.asarray(_conv_xla(jnp.asarray(x), jnp.asarray(w2))), atol=1e-5)

    tx = torch.from_numpy(_nchw(x).copy()).requires_grad_()
    tw = torch.from_numpy(w2.transpose(3, 2, 0, 1).copy()).requires_grad_()
    tg = torch.from_numpy(_nchw(g).copy())
    (stem.stem_conv_s2d(tx, tw) * tg).sum().backward()
    by_hand = stem.stem_conv_s2d_grads(tx.detach(), tw.detach(), tg)
    for name, auto, hand, w in zip(('x', 'w2'), (tx.grad, tw.grad), by_hand,
                                   want):
        tol = 1e-5 * np.abs(w).max()
        np.testing.assert_allclose(auto.numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(hand.numpy(), w, rtol=0, atol=tol,
                                   err_msg=name)
    # only what is needed is computed, in the inputs' dtypes
    gx, gw = stem.stem_conv_s2d_grads(tx.detach().bfloat16(),
                                      tw.detach().bfloat16(), tg.bfloat16(),
                                      need_x=False)
    assert gx is None and gw.dtype == torch.bfloat16
    assert gw.shape == tw.shape


def test_s2d_model_conv1_grad_matches_jax_and_plain_stem(jax_vars):
    """conv1.weight's gradient through the s2d model (the 4x4 weight is
    derived from it inside the graph) against jax.grad through JAX's s2d
    model, within 1e-5 of its largest entry, and against the port's plain
    7x7 stem on the same weights (the same taps in another layout)."""
    cfg = tiny_resnet_config(stem_s2d=True)
    imgs = np.random.RandomState(3).randn(2, 128, 128, 3).astype(np.float32)

    def jax_total(params):
        x = jax_layers.s2d_input(jnp.asarray(imgs), from_rgb=True)
        out = JaxYolact(cfg).apply(
            {'params': params, 'batch_stats': jax_vars['batch_stats']}, x,
            train=False)
        return sum(jnp.sum(out[k] ** 2) for k in ('loc', 'conf', 'proto'))

    want = np.asarray(jax.jit(jax.grad(jax_total))(jax_vars['params'])[
        'backbone']['conv1']['conv']['kernel']).transpose(3, 2, 0, 1)
    sd = jax_variables_to_state_dict(P(cfg), jax_vars)
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2)
    grads = {}
    for s2d in (True, False):
        model = Yolact(P(cfg).copy(stem_s2d=s2d)).eval()
        model.load_state_dict(sd)
        out = model(s2d_input(x, from_rgb=True) if s2d else x)
        sum((out[k] ** 2).sum() for k in ('loc', 'conf', 'proto')).backward()
        grads[s2d] = model.backbone.conv1.weight.grad.numpy()
    tol = 1e-5 * np.abs(want).max()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(grads[True], want, rtol=0, atol=tol)
    np.testing.assert_allclose(grads[True], grads[False], rtol=0, atol=tol)
