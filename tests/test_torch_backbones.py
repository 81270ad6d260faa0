"""The port's other backbones (DarkNet-53, VGG-16, ResNet-GN) and the
no-FPN wiring of yolact_vgg16 against the JAX package, on the CPU.

Weights cross as in the other port tests: the port's seeded
``random_state_dict``, then ``yolact_tpu.convert.torch_import.
convert_state_dict`` to JAX variables; ``convert/from_jax.py`` must give
back the same tensors.  Tolerances, float32: each backbone stage output
within 1e-5 of its largest magnitude; the eval and train forward outputs
within rtol/atol 1e-4 (as ``test_torch_model.py``); the pipeline's
detections as ``test_torch_pipeline.py`` (classes and validity identical,
scores and boxes 1e-5, masks 1e-4); prior counts and backbone imports
exactly.

The tiny configs keep each family's topology at narrow widths: DarkNet
from ``_tiny``, ResNet-GN as the tiny ResNet with ``type='resnet_gn'``,
and VGG-16 as ``yolact_vgg16`` with every group and extra stage but 8-64
channels, at 300 px (its six SSD levels are 38, 19, 10, 5, 3 and 1)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_inputs as TI
from _tiny import tiny_darknet_config, tiny_resnet_config
from yolact_tpu import config as C
from yolact_tpu.convert import backbone_import as jax_bb
from yolact_tpu.convert.torch_import import convert_state_dict
from yolact_tpu.infer import Pipeline as JaxPipeline
from yolact_tpu.infer import preprocess_device as jax_preprocess
from yolact_tpu.models import layers as jax_layers
from yolact_tpu.models.darknet import DarkNetBackbone as JaxDarkNet
from yolact_tpu.models.resnet import ResNetBackbone as JaxResNet
from yolact_tpu.models.vgg import VGGBackbone as JaxVGG
from yolact_tpu.models.yolact import Yolact as JaxYolact
from yolact_tpu.ops.anchors import generate_priors as jax_generate_priors
from yolact_tpu_torch import config as port_config
from yolact_tpu_torch.convert import backbone_import as bb
from yolact_tpu_torch.convert.from_jax import config_from_jax as P
from yolact_tpu_torch.convert.from_jax import (jax_checkpoint_to_port,
                                               jax_variables_to_state_dict,
                                               state_dict_to_train_state,
                                               train_state_to_state_dict)
from yolact_tpu_torch.infer import Pipeline, preprocess_device, \
    random_state_dict
from yolact_tpu_torch.models import layers
from yolact_tpu_torch.models.yolact import Yolact
from yolact_tpu_torch.ops.anchors import generate_priors

torch.set_num_threads(2)

TINY_VGG_ARCH = (
    (8, 8),
    ('M', 16, 16),
    ('M', 16, 16, 16),
    (('M', (('ceil_mode', True), ('kernel_size', 2), ('stride', 2))),
     32, 32, 32),
    ('M', 32, 32, 32),
    (('M', (('kernel_size', 3), ('padding', 1), ('stride', 1))),
     (64, (('dilation', 6), ('kernel_size', 3), ('padding', 6))),
     (64, (('kernel_size', 1),))))


def tiny_vgg_config(**kw):
    """yolact_vgg16 (no FPN, one head per level, protonet on the stride-8
    stage) at narrow widths and 300 px."""
    cfg = C.get_config('yolact_vgg16')
    return cfg.copy(
        max_size=300,
        num_classes=5,
        dataset=cfg.dataset.copy(class_names=('a', 'b', 'c', 'd')),
        backbone=cfg.backbone.copy(
            args=(TINY_VGG_ARCH, ((16, 2), (8, 2), (8, 1), (8, 1)), (3,))),
        mask_proto_net=((8, 3, (('padding', 1),)),
                        (None, -2, ()),
                        (8, 1, ())),
        extra_head_net=((16, 3, (('padding', 1),)),),
        **kw)


def tiny_gn_config(**kw):
    """The tiny ResNet with group norm (RESNET101_GN_BACKBONE's type)."""
    cfg = tiny_resnet_config(**kw)
    return cfg.copy(backbone=cfg.backbone.copy(type='resnet_gn'))


TINY = {'darknet': tiny_darknet_config, 'vgg': tiny_vgg_config,
        'gn': tiny_gn_config}


def yolact_base_gn():
    """yolact_base with RESNET101_GN_BACKBONE's type and args (the repo
    registers no named GN config)."""
    cfg = C.get_config('yolact_base')
    gn = C.RESNET101_GN_BACKBONE
    return cfg.copy(name='yolact_base_gn', backbone=cfg.backbone.copy(
        name=gn.name, path=gn.path, type=gn.type, args=gn.args))


def _sparsify(sd, num_classes, bias):
    """Bias every head's background logit (each VGG level has its own
    head)."""
    sd = dict(sd)
    for key in [k for k in sd if k.endswith('conf_layer.bias')]:
        b = sd[key].clone().view(-1, num_classes)
        b[:, 0] += bias
        sd[key] = b.view(-1)
    return sd


def _weights(cfg, seed=3, sparse=False):
    """(port state dict, JAX variables) of the same seeded weights.
    `sparse`: every head's background logit biased by 2 (DarkNet's tiny
    logits leave no detection at 3) or 3."""
    sd = random_state_dict(P(cfg), torch.Generator().manual_seed(seed))
    if sparse:
        sd = _sparsify(sd, cfg.num_classes,
                       2.0 if cfg.backbone.type == 'darknet' else 3.0)
    v, unhandled = convert_state_dict(cfg, {k: t.numpy()
                                            for k, t in sd.items()})
    assert unhandled == []
    return sd, v


def _assert_close_to_max(got, want, rel, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    assert scale > 0, name
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (name, err, scale)


def _jax_backbone(cfg):
    b = cfg.backbone
    n = max(b.selected_layers) + 1
    if b.type == 'darknet':
        return JaxDarkNet(layers=tuple(b.args[0]),
                          num_stages=max(n, len(b.args[0])))
    if b.type == 'vgg':
        return JaxVGG(arch=b.args[0], extra_args=b.args[1],
                      norm_layers=tuple(b.args[2]),
                      num_stages=max(n, len(b.args[0])))
    return JaxResNet(layers=tuple(b.args[0]), norm='gn',
                     num_stages=max(n, len(b.args[0])))


@pytest.mark.parametrize('family', sorted(TINY))
@pytest.mark.parametrize('train', [False, True], ids=['eval', 'batch_stats'])
def test_backbone_stage_outputs_match_jax(rng, family, train):
    """Every stage's output, float32: within 1e-5 of its largest value (with
    batch statistics where a family has batch norm)."""
    cfg = TINY[family]()
    sd, v = _weights(cfg)
    size = cfg.max_size
    x = rng.randn(2, size, size, 3).astype(np.float32)
    bv = {'params': v['params']['backbone']}
    stats = v['batch_stats'].get('backbone')
    if stats:
        bv['batch_stats'] = stats
    out = _jax_backbone(cfg).apply(bv, jnp.asarray(x), train,
                                   mutable=['batch_stats'] if train else False)
    want = out[0] if train else out
    model = Yolact(P(cfg))
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2),
                             bn_train=train)
    assert len(got) == len(want) >= max(cfg.backbone.selected_layers) + 1
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close_to_max(g.permute(0, 2, 3, 1).numpy(), w, 1e-5,
                             f'{family} stage {i}')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_group_norm_matches_flax(rng, dtype):
    """Flax's GroupNorm computes in float32 and returns the compute dtype;
    so does the port's, whose ``train`` does nothing."""
    x = (rng.randn(2, 5, 7, 64) * 3 + 1).astype(np.float32)
    gn = jax_layers.GroupNorm(dtype=jnp.dtype(dtype))
    v = gn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale = rng.rand(64).astype(np.float32) + 0.5
    bias = rng.randn(64).astype(np.float32)
    v = {'params': {'gn': {'scale': scale, 'bias': bias}}}
    xd = jnp.asarray(x).astype(dtype)
    want = np.asarray(gn.apply(v, xd).astype(jnp.float32))
    layer = layers.GroupNorm(64)
    layer.load_state_dict({'weight': torch.from_numpy(scale),
                           'bias': torch.from_numpy(bias)})
    xt = torch.from_numpy(np.asarray(xd.astype(jnp.float32))).to(
        getattr(torch, dtype)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = layer(xt, True)
    assert got.dtype == xt.dtype
    assert not any(n.startswith('running') for n in layer.state_dict())
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # one bf16 rounding of a float32 result each side
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize('size', [7, 8, 13, 38])
@pytest.mark.parametrize('kernel,stride,padding,ceil_mode', [
    (2, 2, 0, False), (2, 2, 0, True), (3, 1, 1, False), (3, 2, 1, False),
    (3, 2, 0, True)])
def test_max_pool_matches_jax(rng, size, kernel, stride, padding,
                              ceil_mode):
    """Odd and even sizes; torch's ceil_mode drops a last window starting
    in the right padding, which JAX's does not, so ceil_mode runs with
    padding 0, as in every config."""
    x = rng.randn(2, size, size + 1, 3).astype(np.float32)
    want = jax_layers.max_pool(jnp.asarray(x), kernel, stride, padding,
                               ceil_mode)
    got = layers.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), kernel,
                          stride, padding, ceil_mode)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize('family', sorted(TINY))
def test_weights_round_trip(family):
    """random_state_dict -> convert_state_dict -> from_jax: the same
    tensors, the train-state converters and a JAX .ckpt train state
    included (weights and momentum)."""
    cfg = TINY[family](use_class_existence_loss=True)
    sd, v = _weights(cfg)
    back = jax_variables_to_state_dict(P(cfg), v)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    Yolact(P(cfg)).load_state_dict(back, strict=True)
    params, stats = {'model': v['params']}, v['batch_stats']
    assert train_state_to_state_dict(P(cfg), params, stats).keys() == \
        sd.keys()
    new_params, new_stats = state_dict_to_train_state(sd, params, stats)
    flat = dict(jax.tree_util.tree_leaves_with_path(
        {'params': new_params, 'batch_stats': new_stats}))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            {'params': params, 'batch_stats': stats}):
        np.testing.assert_array_equal(flat[path], leaf)
    momentum = jax.tree_util.tree_map(lambda a: a * 0.5, params)
    blob = {'step': np.int32(7), 'params': params, 'batch_stats': stats,
            'opt_state': {'1': {'trace': momentum}}}
    port = jax_checkpoint_to_port(P(cfg), blob)
    assert port['step'] == 7
    for k, t in port['model'].items():
        assert torch.equal(t, sd[k]), k
    assert port['momentum'].keys() == {
        k for k in sd if 'running_' not in k}
    for k, t in port['momentum'].items():
        assert torch.equal(t, sd[k] * 0.5), k


def test_darknet_and_vgg_names():
    """The reference's torch names, as JAX's importer reads them."""
    with torch.device('meta'):
        dark = Yolact(P(tiny_darknet_config())).state_dict()
        vgg = Yolact(P(tiny_vgg_config())).state_dict()
        gn = Yolact(P(tiny_gn_config())).state_dict()
    for key in ('backbone._preconv.0.weight', 'backbone._preconv.1.running_var',
                'backbone.layers.0.0.0.weight', 'backbone.layers.0.0.1.bias',
                'backbone.layers.4.1.conv2.0.weight',
                'backbone.layers.4.1.conv1.1.running_mean'):
        assert key in dark, key
    for key in ('backbone.layers.0.2.weight', 'backbone.layers.1.3.bias',
                'backbone.layers.5.1.weight', 'backbone.layers.5.3.weight',
                'backbone.layers.9.2.weight', 'backbone.norms.0.weight',
                'prediction_layers.5.conf_layer.weight'):
        assert key in vgg, key
    assert vgg['backbone.layers.5.1.weight'].shape == (64, 32, 3, 3)
    assert vgg['proto_net.0.weight'].shape[1] == 32
    assert 'backbone.layers.3.0.downsample.1.weight' in gn
    assert not any('running' in k for k in gn if k.startswith('backbone.'))


@pytest.mark.parametrize('name', ['yolact_darknet53', 'yolact_vgg16',
                                  'yolact_base_gn'])
def test_full_width_names_and_shapes_match_jax(name):
    """At full width and 550 px: every parameter has the reference's torch
    name and the shape the JAX tree implies (nothing is computed)."""
    cfg = yolact_base_gn() if name == 'yolact_base_gn' else \
        C.get_config(name)
    shapes = jax.eval_shape(
        lambda: JaxYolact(cfg).init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 550, 550, 3)),
                                    train=True))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape),
        {'params': shapes['params'],
         'batch_stats': shapes.get('batch_stats', {})})
    want = {k: tuple(t.shape)
            for k, t in jax_variables_to_state_dict(P(cfg), zeros).items()}
    with torch.device('meta'):
        model = Yolact(P(cfg))
    got = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert got == want


@pytest.mark.parametrize('family', sorted(TINY))
def test_eval_forward_matches_jax(family):
    cfg = TINY[family]()
    sd, v = _weights(cfg, seed=5)
    rng = np.random.RandomState(11)
    size = cfg.max_size
    frames = rng.randint(0, 256, (2, size, size, 3)).astype(np.float32)
    want = JaxYolact(cfg).apply(v, jax_preprocess(cfg, jnp.asarray(frames)),
                                train=False)
    model = Yolact(P(cfg)).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(preprocess_device(P(cfg), torch.from_numpy(frames)))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize('family', sorted(TINY))
def test_train_forward_matches_jax(rng, family):
    """forward(train=True): batch statistics where a family has batch norm,
    and the training-only heads on the first (segm) and last (classes) head
    level, at those levels' widths (VGG's 32 and 16 channels)."""
    cfg = TINY[family](use_class_existence_loss=True)
    sd, v = _weights(cfg, seed=4)
    size = cfg.max_size
    x = rng.randn(2, size, size, 3).astype(np.float32)
    has_bn = bool(v['batch_stats'])
    out = JaxYolact(cfg).apply(
        {'params': v['params'], 'batch_stats': v['batch_stats']},
        jnp.asarray(x), train=True,
        mutable=['batch_stats'] if has_bn else False)
    want = out[0] if has_bn else out
    model = Yolact(P(cfg))
    model.load_state_dict(sd, strict=True)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    assert {'segm', 'classes'} <= set(got)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize('family', sorted(TINY))
def test_pipeline_matches_jax(family):
    """Pipeline on raw frames, sparse conf cell: the GN path takes the s2d
    stem in both packages, DarkNet and VGG their own 3x3 stems."""
    cfg = TINY[family]()
    sd, v = _weights(cfg, sparse=True)
    size = cfg.max_size
    frames = np.random.RandomState(7).randint(
        0, 256, (2, size, size, 3)).astype(np.float32)
    want = JaxPipeline(cfg, v)(frames)
    pipe = Pipeline(P(cfg), sd, 'cpu')
    assert pipe.cfg.stem_s2d == (family == 'gn')
    got = pipe(frames)
    assert bool(got.valid.any())
    np.testing.assert_array_equal(np.asarray(want.valid), got.valid.numpy())
    np.testing.assert_array_equal(np.asarray(want.classes),
                                  got.classes.numpy())
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.masks.numpy(), np.asarray(want.masks),
                               rtol=0, atol=1e-4)


NAMES = [n for n in port_config.config_names()
         if port_config.get_config(n).backbone is not None]


def test_nine_model_configs():
    assert len(NAMES) == 9 and 'yolact_vgg16' in NAMES \
        and 'yolact_darknet53' in NAMES


@pytest.mark.parametrize('name', NAMES + ['yolact_base_gn'])
def test_prior_counts_match_jax(name):
    """Every model config at its max_size: the JAX package's priors, bit
    for bit."""
    cfg = yolact_base_gn() if name == 'yolact_base_gn' else \
        C.get_config(name)
    want = jax_generate_priors(cfg)
    got = generate_priors(P(cfg))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('name', NAMES)
def test_every_config_runs_through_pipeline(name):
    """Yolact(cfg) and Pipeline at the config's full width and max_size,
    seeded random weights, one frame on the CPU: finite outputs of the
    padded shapes."""
    cfg = port_config.get_config(name)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    frame = np.random.RandomState(1).randint(
        0, 256, (1, cfg.max_size, cfg.max_size, 3)).astype(np.float32)
    out = Pipeline(cfg, sd, 'cpu')(frame)
    d = cfg.max_num_detections
    assert tuple(out.boxes.shape) == (1, d, 4)
    assert tuple(out.masks.shape[:2]) == (1, d)
    for t in (out.boxes, out.scores, out.masks):
        assert bool(torch.isfinite(t).all())


def test_stem_s2d_rejected_for_non_resnet():
    for make in (tiny_darknet_config, tiny_vgg_config):
        with pytest.raises(ValueError, match='ResNet'):
            Yolact(P(make(stem_s2d=True)))


def _vgg_flat_sd(arch, gen):
    """torchvision VGG ``features`` keys (a flat Sequential, ReLUs and pools
    counted) for `arch`, seeded values; and a classifier to be dropped."""
    sd, i, cin = {}, 0, 3
    for group in arch:
        for v in group:
            v, kw = (v[0], dict(v[1])) if isinstance(v, tuple) else (v, None)
            if v == 'M':
                i += 1
                continue
            k = (kw or {'kernel_size': 3}).get('kernel_size', 3)
            sd[f'{i}.weight'] = torch.randn(v, cin, k, k, generator=gen)
            sd[f'{i}.bias'] = torch.randn(v, generator=gen)
            cin, i = v, i + 2
    sd['classifier.0.weight'] = torch.zeros(2, 2)
    return sd


def _gn_blob(num_layers, gen):
    """A Detectron GN blob dict of a ResNet with `num_layers` blocks."""
    def arr(*shape):
        return torch.randn(*shape, generator=gen).numpy()
    blob = {'conv1_w': arr(64, 3, 7, 7), 'conv1_gn_s': arr(64),
            'conv1_gn_b': arr(64), 'fc1000_w': arr(2, 2)}
    cin = 64
    for si, n in enumerate(num_layers):
        planes = 64 * 2 ** si
        for bi in range(n):
            p = f'res{si + 2}_{bi}'
            shapes = {'branch2a': (planes, cin, 1, 1),
                      'branch2b': (planes, planes, 3, 3),
                      'branch2c': (planes * 4, planes, 1, 1)}
            if bi == 0:
                shapes['branch1'] = (planes * 4, cin, 1, 1)
            for br, shape in shapes.items():
                blob[f'{p}_{br}_w'] = arr(*shape)
                blob[f'{p}_{br}_gn_s'] = arr(shape[0])
                blob[f'{p}_{br}_gn_b'] = arr(shape[0])
            cin = planes * 4
    return blob


@pytest.mark.parametrize('family', sorted(TINY))
def test_backbone_import_matches_jax(tmp_path, family):
    """The pretraining files of each family (a torchvision-flat VGG
    ``.pth``, a Detectron GN ``.pkl`` of blobs under 'blobs', a DarkNet
    ``.pth`` in the reference's layout): the key maps equal JAX's, and
    load + merge gives JAX's weights bit for bit (VGG's norms and extra
    stages, which the file lacks, keep their init)."""
    cfg = TINY[family]()
    sd, _ = _weights(cfg)
    gen = torch.Generator().manual_seed(2)
    if family == 'vgg':
        raw = _vgg_flat_sd(cfg.backbone.args[0], gen)
        got = bb.vgg_backbone_sd(cfg.backbone.args[0], raw)
        want = jax_bb.vgg_backbone_sd(cfg.backbone.args[0], raw)
        assert got.keys() == want.keys() and 'layers.5.3.weight' in got
        path = tmp_path / 'vgg.pth'
        torch.save(raw, path)
    elif family == 'gn':
        raw = _gn_blob(cfg.backbone.args[0], gen)
        got = bb.gn_backbone_sd(cfg.backbone.args[0], raw)
        want = jax_bb.gn_backbone_sd(cfg.backbone.args[0], raw)
        assert got.keys() == want.keys()
        path = tmp_path / 'gn.pkl'
        with open(path, 'wb') as f:
            pickle.dump({'blobs': raw}, f)
    else:
        raw = {k[len('backbone.'):]: torch.randn(t.shape, generator=gen)
               for k, t in sd.items() if k.startswith('backbone.')}
        path = tmp_path / 'darknet.pth'
        torch.save(raw, path)
    if family != 'darknet':
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    merged = bb.merge_backbone(sd, bb.load_backbone_weights(P(cfg),
                                                            str(path)),
                               P(cfg))
    jax_vars = jax_bb.load_backbone_weights(cfg, str(path))
    jax_sd = {k: t for k, t in
              jax_variables_to_state_dict(P(cfg), jax_vars).items()
              if k.startswith('backbone.')}
    backbone = {k for k in sd if k.startswith('backbone.')}
    lack = tuple(bb.backbone_keys_not_in_files(P(cfg)))
    assert bool(lack) == (family == 'vgg')
    assert set(jax_sd) == {k for k in backbone if not k.startswith(lack)}
    for k in sd:
        want_t = jax_sd.get(k, sd[k])
        assert torch.equal(merged[k], want_t), k


@pytest.mark.parametrize('family', sorted(TINY))
def test_trainer_runs(tmp_path, family):
    """cli/train on in-memory frames for three steps with mid-run
    validation: every step applied, finite losses, a mAP table, the first
    conv's weight moved.  Batch 2 turns on freeze_bn (as in JAX): batch
    norm keeps its statistics and parameters, group norm (which JAX's
    freeze_bn does not freeze either) trains."""
    from test_torch_inputs import SyntheticEvalSet, SyntheticTrainSet
    from yolact_tpu_torch.cli import train as cli
    from yolact_tpu_torch.config import register_config
    from yolact_tpu_torch.data.augmentations import SSDAugmentation
    name = f'tiny_{family}_trainer'
    cfg = P(TINY[family]()).copy(name=name, max_iter=3, lr_warmup_until=0)
    register_config(cfg)
    s = cfg.max_size
    train = SyntheticTrainSet(4, ((s - 20, s + 10), (s, s)), cfg.num_classes,
                              SSDAugmentation(cfg), seed=1)
    val = SyntheticEvalSet(2, s, cfg.num_classes, seed=2)
    save = str(tmp_path / 'w')
    run = cli.train(['--config', name, '--batch_size', '2', '--no_autoscale',
                     '--save_folder', save, '--log_folder',
                     str(tmp_path / 'logs'), '--num_workers', '1',
                     '--max_gt', '8', '--cuda=False',
                     '--validation_epoch', '1'],
                    dataset=train, val_dataset=val)
    assert run['iteration'] == 3 and set(run['maps']) == {'box', 'mask'}
    assert all(np.isfinite(v) for e in run['losses']
               for v in e['loss'].values())
    start = random_state_dict(cfg, torch.Generator().manual_seed(0))
    end = run['state'].model.state_dict()
    first = {'darknet': 'backbone._preconv.0.weight',
             'vgg': 'backbone.layers.0.0.weight',
             'gn': 'backbone.conv1.weight'}[family]
    assert not torch.equal(end[first], start[first])
    bn = [k for k in end if k.endswith('running_mean')]
    assert bool(bn) == (family != 'gn')
    for k in bn:
        for leaf in ('running_mean', 'running_var', 'weight', 'bias'):
            key = k[:-len('running_mean')] + leaf
            assert torch.equal(end[key], start[key]), key
    if family == 'gn':
        assert not torch.equal(end['backbone.bn1.weight'],
                               start['backbone.bn1.weight'])


LAYOUT_CONFIGS = {
    'yolact_base': lambda: TI.tiny_resnet_config(nms_candidates=256),
    'yolact_plus_base': lambda: TI.tiny_plus_config(nms_candidates=256),
    'darknet': lambda: TI.tiny_darknet_config(nms_candidates=256),
    'vgg': lambda: TI.tiny_vgg_config(nms_candidates=256),
    'resnet_gn': lambda: TI.tiny_gn_config(nms_candidates=256),
}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', sorted(LAYOUT_CONFIGS))
def test_maps_and_weights_are_channels_last(name, dtype, monkeypatch):
    """After ``load_model`` every conv and DCN weight outside the mask
    scorer is channels_last in the compute dtype, and ``Conv2d`` hands it
    to the conv as it is (same storage).  On the input a Pipeline gives
    the model (the s2d one for the ResNets), every trunk stage output,
    FPN level and proto map is channels_last, and the heads' flattens and
    the prototypes' permute are views."""
    from yolact_tpu_torch.infer import (_prepare_input, load_model,
                                        maybe_enable_stem_s2d)
    from yolact_tpu_torch.models.resnet import DCNLayer
    cfg = maybe_enable_stem_s2d(LAYOUT_CONFIGS[name]())
    assert cfg.stem_s2d == (name not in ('darknet', 'vgg'))
    model = load_model(cfg, random_state_dict(
        cfg, torch.Generator().manual_seed(0)), torch.device('cpu'), dtype)
    want = getattr(torch, dtype)
    scorer = (set(model.maskiou_net.modules())
              if model.maskiou_net is not None else set())
    convs = [m for m in model.modules() if m not in scorer and isinstance(
        m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, DCNLayer))]
    for m in convs:
        assert m.weight.dtype == want
        assert m.weight.is_contiguous(memory_format=torch.channels_last)

    passed = []
    conv_forward = layers.Conv2d._conv_forward

    def spy(self, x, weight, bias):
        passed.append(weight.data_ptr() == self.weight.data_ptr())
        return conv_forward(self, x, weight, bias)

    monkeypatch.setattr(layers.Conv2d, '_conv_forward', spy)
    frames = np.random.RandomState(0).randint(
        0, 256, (2, cfg.max_size, cfg.max_size, 3)).astype(np.float32)
    cl = torch.channels_last
    with torch.no_grad():
        x = _prepare_input(cfg, torch.from_numpy(frames), True)
        outs = model.backbone(x.to(want))
        levels = [outs[i] for i in cfg.backbone.selected_layers]
        if model.fpn is not None:
            levels = model.fpn(levels)
        proto = model.proto_net(levels[cfg.mask_proto_src])
        preds = model(x)
    assert passed and all(passed)
    for t in (*outs, *levels, proto):
        assert t.is_contiguous(memory_format=cl), tuple(t.shape)
    assert preds['proto']._base is not None          # a view, no copy
    assert preds['proto'].is_contiguous()
