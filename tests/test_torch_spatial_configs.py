"""Spatial partitioning of every other config (``--spatial_split`` beyond
the ResNet slice of ``tests/test_torch_spatial.py``) on the CPU: gloo ranks
started with ``spawn`` (``tests/torch_parallel_worker.py``), each running
``tests/torch_spatial_worker.py``, which imports no JAX.

What is held:

* the row ops these configs add, against the whole-map op, forward and
  float64 gradients, on 2 and 3 ranks and on a map of 2 rows over 3 ranks
  (one rank owns none): VGG's ceil-mode and 3/1/1 pools and dilation-6
  conv, transposed convs (strides 1 and 2, ``output_padding``), the
  stride-2 subsample, a ``'cat'`` entry, group norm's moments over the
  space ranks;
* the float64 step on two ranks (VGG on three) against the one-process
  step within 1e-6 (losses, first gradients, weights after the step):
  DarkNet-53, VGG-16, ResNet-GN with either stem, direct masks, every
  lincomb option together (grid, prototypes as features, proto bias,
  ``'cat'`` and transposed head layers, the prediction module, ...), an
  FPN without downsample convs and prototypes from the image; float32
  for the ranks' bit-equality on two; two controls that must fail (group
  norm's moments over a rank's own rows; the prototype features gathered
  with the loss's gradient);
* DarkNet and VGG against JAX's ``make_mesh_2d`` on the same numpy inputs
  (data 1 x space 2): the losses of JAX's 2-D mesh step at its rtol 2e-4,
  the update against JAX's ONE-device step (JAX's own 2-D mesh gets the
  FPN's first downsample gradient wrong, ROADMAP C), and split inference
  against JAX's 2-D mesh inference;
* ``cli/train.train(['--distributed', '--spatial_split', '2', ...])`` of a
  tiny DarkNet config on two ranks, then ``--resume latest``.
"""

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_spatial_worker as W
from test_torch_inputs import (make_train_batch, tiny_darknet_config,
                               tiny_gn_config, tiny_option_overrides,
                               tiny_resnet_config, tiny_vgg_config,
                               write_grid)
from torch_parallel_worker import Ranks, free_port, run_ranks
from yolact_tpu_torch.config import MaskType
from yolact_tpu_torch.infer import random_state_dict
from yolact_tpu_torch.parallel import mesh as parallel

torch.set_num_threads(2)

# ---- the row ops -------------------------------------------------------------

OP_GRIDS = {'S2': (2, 11), 'S3': (3, 11), 'S3_2rows': (3, 2)}
_OPS = {}


def _ops(grid):
    if grid not in _OPS:
        space, height = OP_GRIDS[grid]
        _OPS[grid] = run_ranks(W.config_ops_run, space, space, height)
    return _OPS[grid]


@pytest.mark.parametrize('grid,name', [
    (grid, name) for grid in OP_GRIDS for name in W.config_op_cases()])
def test_config_row_op_matches_the_whole_map_op(grid, name):
    """Each rank's output rows are the whole op's rows, and its input
    gradient the whole op's rows of it, in float64 within 1e-12."""
    space, height = OP_GRIDS[grid]
    ranks = _ops(grid)
    whole = W.config_op_cases(height)[name][0]
    x = W.whole_map(0, W.map_shape(height)).clone().requires_grad_(True)
    y = whole(x)
    (y * W.whole_map(1, tuple(y.shape))).sum().backward()
    for rank, got in enumerate(ranks):
        lo, hi = got[name]['own']
        assert (lo, hi) == parallel.own(y.shape[2], rank, space)
        np.testing.assert_allclose(got[name]['y'],
                                   y.detach().numpy()[:, :, lo:hi],
                                   rtol=0, atol=1e-12)
    grad = np.concatenate([r[name]['grad'] for r in ranks], 2)
    np.testing.assert_allclose(grad, x.grad.numpy(), rtol=0, atol=1e-12)


def test_ceil_mode_pool_reads_a_row_beyond_the_map():
    """VGG's group-3 pool at 550: 137 rows in, 69 out, the last window
    starting on row 136 and reaching row 137, beyond the map; a window
    starting in the right padding is dropped, as torch drops it."""
    from yolact_tpu_torch.models.layers import pool_out_size
    assert pool_out_size(137, 2, 2, 0, True) == 69
    assert pool_out_size(137, 2, 2, 0, False) == 68
    assert pool_out_size(34, 3, 1, 1) == 34
    for k, s, p in ((2, 2, 0), (3, 2, 1), (3, 2, 0), (3, 3, 1)):
        for n in range(k, 40):
            x = torch.zeros(1, 1, n, 1)
            want = torch.nn.functional.max_pool2d(
                x, (k, 1), (s, 1), (p, 0), ceil_mode=True).shape[2]
            assert pool_out_size(n, k, s, p, True) == want, (n, k, s, p)


# ---- the train step ----------------------------------------------------------

_GRID = []


def _options_config(**kw):
    """Every lincomb option together (``tiny_option_overrides``), its
    grid file in a temporary directory the ranks read too."""
    if not _GRID:
        _GRID.append(write_grid(os.path.join(
            tempfile.mkdtemp(prefix='spatial_grid_'), 'grid.npy')))
    return tiny_resnet_config(**kw).copy(**tiny_option_overrides(_GRID[0]))


def _no_downsample_config(**kw):
    cfg = tiny_resnet_config(**kw)
    return cfg.copy(fpn=cfg.fpn.copy(use_conv_downsample=False))


# name: (config, space, float32 steps, controls); every case on one data
# rank, a global batch of 2, one float64 step
CASES = {
    'darknet': (tiny_darknet_config, 2, True, ()),
    'vgg_s3': (tiny_vgg_config, 3, False, ()),
    'gn': (tiny_gn_config, 2, False, ('local_gn',)),
    'gn_s2d': (lambda **kw: tiny_gn_config(stem_s2d=True, **kw), 2, False,
               ()),
    'direct': (lambda **kw: tiny_resnet_config(mask_type=MaskType.DIRECT,
                                               **kw), 2, False, ()),
    'options': (_options_config, 2, False, ()),
    # three ranks: each level's prototype features then read rows that
    # another rank owns (two split 32 rows on the levels' own boundaries,
    # where only the 1-row level, which this batch's loss never reaches,
    # reads across)
    'options_s3': (_options_config, 3, True, ('shared_features',)),
    'fpn_no_downsample': (_no_downsample_config, 2, False, ()),
    'proto_src_image': (lambda **kw: tiny_resnet_config(mask_proto_src=None,
                                                        **kw), 2, False, ()),
}
_RUNS = {}


def _inputs(cfg):
    """Seeded weights and three global batches of 2, the third with a NaN
    pixel in its last image."""
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    batches = [make_train_batch(np.random.RandomState(2 + i), cfg, B=2)
               for i in range(3)]
    batches[2]['image'][-1, 5, 5, 0] = np.nan
    return sd, batches


def _runs():
    """Every case's config, its one-process float64 run and its ranks'
    results: one set of ranks for each space size, started together while
    this process runs the one-process side."""
    if not _RUNS:
        by_space, made = {}, {}
        for name, (make, space, f32, controls) in CASES.items():
            cfg = make(use_class_balanced_conf=True)
            sd, batches = _inputs(cfg)
            made[name] = (cfg, sd, batches)
            by_space.setdefault(space, []).append(
                (name, cfg, sd, batches if f32 else batches[:1], 1, f32,
                 controls))
        ranks = {space: Ranks(W.cases_run, space, space, cases)
                 for space, cases in by_space.items()}
        one = {name: W.float64_run(None, None, cfg, sd, batches[:1])
               for name, (cfg, sd, batches) in made.items()}
        got = {space: r.results() for space, r in ranks.items()}
        for name, (cfg, _, _) in made.items():
            _RUNS[name] = (cfg, one[name],
                           [r[name] for r in got[CASES[name][1]]])
    return _RUNS


def _rounding_only(key):
    """The prediction module's 1x1 conv bias, before a batch norm on batch
    statistics: its gradient is zero but for rounding."""
    return key.startswith('prediction_layers.') and key.endswith('.conv.bias')


def _worst(got, want):
    """The largest error of any tensor relative to its largest entry (a
    gradient that is zero but for rounding within 1e-12)."""
    assert got.keys() == want.keys()
    worst = 0.0
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        if _rounding_only(k) and float(np.abs(w).max()) < 1e-12:
            assert err < 1e-12, k
            continue
        worst = max(worst, err / max(float(np.abs(w).max()), 1e-12))
    return worst


@pytest.mark.parametrize('name', list(CASES))
def test_config_losses_match_one_process_in_float64(name):
    _, one, ranks = _runs()[name]
    for got in ranks:
        a, w = got['f64']['steps'][0], one['steps'][0]
        assert a.keys() == w.keys()
        for k, v in w.items():
            assert abs(a[k] - v) <= 1e-6 * abs(v), (k, a[k], v)


@pytest.mark.parametrize('name', list(CASES))
def test_config_gradients_and_weights_match_one_process_in_float64(name):
    """The first step's gradients, and the weights and running statistics
    after it, within 1e-6 of each tensor's largest entry; every trained
    parameter has a gradient on every rank."""
    _, one, ranks = _runs()[name]
    for got in ranks:
        assert _worst(got['f64']['grads'], one['grads']) <= 1e-6
        assert _worst(got['f64']['weights'], one['weights']) <= 1e-6


@pytest.mark.parametrize('name', [n for n in CASES if CASES[n][2]])
def test_config_ranks_stay_bit_equal_in_float32(name):
    """Every rank's weights and buffers are the same bits after every
    step; the losses are finite; the NaN pixel of the third batch skips
    the step on every rank."""
    _, _, ranks = _runs()[name]
    first = ranks[0]['f32']
    for got in ranks:
        steps = got['f32']['steps']
        assert [s['finite'] for s in steps] == [True, True, False]
        assert all(np.isfinite(v) for s in steps[:2] for k, v in s.items()
                   if k != 'finite')
        for a, w in zip(got['f32']['weights'], first['weights']):
            assert all(np.array_equal(a[k], w[k]) for k in w)
    w1, w2 = first['weights'][1], first['weights'][2]
    assert all(np.array_equal(w1[k], w2[k]) for k in w1)


@pytest.mark.parametrize('name,control', [('gn', 'local_gn'),
                                          ('options_s3', 'shared_features')])
def test_config_controls_fail(name, control):
    """Group norm's moments over each rank's own rows move the losses and
    the gradients; the prototype features gathered with the loss's
    'shared' gradient keep the losses but drop the other ranks' feature
    gradients: both far beyond the 1e-6 the spatial step keeps."""
    _, one, ranks = _runs()[name]
    got = ranks[0]['controls'][control]
    loss_gap = max(abs(got['steps'][0][k] - v) / abs(v)
                   for k, v in one['steps'][0].items())
    grad_gap = _worst(got['grads'], one['grads'])
    assert max(loss_gap, grad_gap) > 1e-3, (loss_gap, grad_gap)
    if control == 'shared_features':
        assert loss_gap < 1e-6 < grad_gap


# ---- against JAX's 2-D mesh --------------------------------------------------

def _jax_tiny(name, **kw):
    """The JAX package's tiny config of `name` ('darknet' or 'vgg'), the
    same topology as the port-side builders above."""
    import _tiny
    from yolact_tpu import config as C
    if name == 'darknet':
        return _tiny.tiny_darknet_config(**kw)
    port = tiny_vgg_config()
    cfg = C.get_config('yolact_vgg16')
    return cfg.copy(
        max_size=port.max_size, num_classes=port.num_classes,
        dataset=cfg.dataset.copy(class_names=port.dataset.class_names),
        backbone=cfg.backbone.copy(args=port.backbone.args),
        mask_proto_net=port.mask_proto_net,
        extra_head_net=port.extra_head_net, **kw)


@pytest.mark.parametrize('name,port', [('darknet', tiny_darknet_config),
                                       ('vgg', tiny_vgg_config)])
def test_port_side_tiny_configs_equal_jax(name, port):
    """The port-side tiny configs (test_torch_inputs.py, which the ranks
    and the CUDA tests build without JAX) are the JAX package's."""
    from yolact_tpu_torch.convert.from_jax import config_from_jax
    assert config_from_jax(_jax_tiny(name)) == port()


@pytest.fixture(scope='module')
def jax_runs():
    """For DarkNet and VGG, one set of 2 ranks (the port's data 1 x space
    2) and JAX's data 1 x space 2 mesh and one device: the step with
    frozen batch norm from the same weights, batch of 2 and draws, and
    inference on host-normalized frames (the port's ``Pipeline`` against
    JAX's ``forward_and_detect``)."""
    import jax
    import jax.numpy as jnp
    from test_torch_loss import jax_draws
    from test_torch_pipeline import _variables
    from test_torch_train import _jax_state, _numpy
    from yolact_tpu.infer import forward_and_detect as jax_forward_and_detect
    from yolact_tpu.models.yolact import Yolact as JaxYolact
    from yolact_tpu.parallel.mesh import (make_mesh_2d, replicate,
                                          shard_batch_spatial)
    from yolact_tpu.train.step import train_step as jax_train_step
    from yolact_tpu_torch.convert.from_jax import config_from_jax as P
    from yolact_tpu_torch.convert.from_jax import (
        jax_variables_to_state_dict, train_state_to_state_dict)
    from yolact_tpu_torch.ops.anchors import generate_priors
    mesh = make_mesh_2d(jax.devices()[:2], data=1, space=2)
    out, ranks, jobs = {}, {}, {}
    for name in ('darknet', 'vgg'):
        jcfg = _jax_tiny(name, freeze_bn=True)
        model, jstate = _jax_state(jcfg)
        batch = make_train_batch(np.random.RandomState(0), P(jcfg), B=2)
        key = jax.random.PRNGKey(7)
        p = len(generate_priors(P(jcfg), (jcfg.max_size, jcfg.max_size)))
        draws = jax_draws(key, 2, p, jcfg.masks_to_train)
        sd = train_state_to_state_dict(P(jcfg), _numpy(jstate.params),
                                       _numpy(jstate.batch_stats))
        icfg = _jax_tiny(name, nms_candidates=256)
        variables = _variables(icfg, False)
        imgs = np.random.RandomState(0).rand(
            1, icfg.max_size, icfg.max_size, 3).astype(np.float32)
        ranks[name] = Ranks(W.step_and_infer_run, 2, 2, P(jcfg), sd,
                            [batch], [draws], P(icfg),
                            jax_variables_to_state_dict(P(icfg), variables),
                            imgs)
        step = jax.jit(lambda s, x, r, c=jcfg, m=model:
                       jax_train_step(c, m, s, x, r))
        detect = jax.jit(lambda v, x, c=icfg: jax_forward_and_detect(
            c, JaxYolact(c), v, x, preprocess=False))
        jobs[name, 'spatial'] = (step, (
            jax.device_put(jstate, replicate(mesh)),
            shard_batch_spatial(mesh, batch), key))
        jobs[name, 'one'] = (step, (jstate, batch, key))
        jobs[name, 'detections'] = (detect, (
            variables, shard_batch_spatial(mesh, jnp.asarray(imgs))))
        out[name] = dict(jstate=jstate)
    # XLA compiles the six programs in threads of its own, side by side
    with ThreadPoolExecutor(len(jobs)) as pool:
        compiled = list(pool.map(lambda job: job[0].lower(*job[1]).compile(),
                                 jobs.values()))
    for (name, what), fn, (_, args) in zip(jobs, compiled, jobs.values()):
        out[name][what] = fn(*args)
    for name, r in ranks.items():
        out[name]['ranks'] = r.results()
    return out


@pytest.mark.parametrize('name', ['darknet', 'vgg'])
def test_spatial_config_step_matches_jax_2d_mesh_losses(jax_runs, name):
    """Each loss letter within JAX's own rtol 2e-4 of its 2-D mesh step's,
    on both ranks."""
    _, jlosses = jax_runs[name]['spatial']
    for got in jax_runs[name]['ranks']:
        step = got['step']['steps'][0]
        assert step['finite']
        for k in jlosses:
            np.testing.assert_allclose(step[k], float(jlosses[k]),
                                       rtol=2e-4, err_msg=k)


@pytest.mark.parametrize('name', ['darknet', 'vgg'])
def test_spatial_config_step_matches_jax_one_device_update(jax_runs, name):
    """Every parameter after the step within the learning rate times 1e-3
    of its momentum's largest entry plus float32 rounding of JAX's
    ONE-device step's, and the momentum of the heads and the protonet
    within 1e-3 of its largest entry (tests/test_torch_spatial.py's
    criterion: the backbone's momentum is held to the one-process step in
    float64 above)."""
    from test_torch_train import _leaves, _numpy
    from yolact_tpu_torch.convert.from_jax import state_dict_to_train_state
    run = jax_runs[name]
    jstate = run['jstate']
    jnew, jlosses = run['one']
    old = _numpy(jstate.params), _numpy(jstate.batch_stats)
    got = run['ranks'][0]['step']
    bufs, _ = state_dict_to_train_state(got['momentum'], *old)
    bufs = {k: v for k, v in _leaves(bufs).items() if v is not None}
    want_bufs = _leaves(jnew.opt_state[1].trace)
    frozen = {k for k in want_bufs if "['bn']" in k or "['norms_" in k}
    assert want_bufs.keys() - frozen == bufs.keys()
    params, _ = state_dict_to_train_state(got['weights'][0], *old)
    params, want_params = _leaves(params), _leaves(jnew.params)
    lr = float(jlosses['lr'])
    heads = [k for k in bufs if "['prediction_layers_" in k
             or "['proto_net']" in k]
    assert heads
    for k, g in bufs.items():
        w = want_bufs[k]
        tol = max(np.abs(w).max(), 1e-6) * 1e-3
        if k in heads:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)
        np.testing.assert_allclose(
            params[k], want_params[k], rtol=0, err_msg=k,
            atol=lr * tol + 1e-6 * np.abs(want_params[k]).max())


@pytest.mark.parametrize('name', ['darknet', 'vgg'])
def test_spatial_config_inference_matches_jax_2d_mesh(jax_runs, name):
    """Both ranks' detections against JAX's 2-D mesh forward_and_detect:
    the same valid slots and classes, scores and boxes within 1e-5, masks
    within 1e-4."""
    from test_torch_pipeline import _assert_outputs_match
    from yolact_tpu_torch.infer import InferenceOutput
    want = jax_runs[name]['detections']
    for got in jax_runs[name]['ranks']:
        out = got['infer']
        assert bool(out['valid'].any())
        _assert_outputs_match(
            type(want)(*[None if v is None else np.asarray(v)
                         for v in want]),
            InferenceOutput(**{k: torch.from_numpy(v)
                               for k, v in out.items()}))


# ---- cli/train.py --spatial_split --------------------------------------------

def test_cli_spatial_split_trains_and_resumes_darknet(tmp_path):
    """A tiny DarkNet config through ``cli/train.train(['--distributed',
    '--spatial_split', '2', ...])`` on two ranks for 2 iterations, then
    ``--resume latest`` for 1 more: rank 0 alone saves, the resumed run
    starts at 2 and ends at 3, the ranks' weights stay bit-equal, and both
    space ranks' forwards take the same prepared batch."""
    cfg = tiny_darknet_config().copy(name='tinyspatialdark',
                                     lr_warmup_until=0)
    argv = ['--distributed', '--spatial_split', '2', '--cuda=False',
            '--config', cfg.name, '--batch_size', '2', '--no_autoscale',
            '--save_folder', str(tmp_path / 'w'), '--log_folder',
            str(tmp_path / 'logs'), '--num_workers', '2', '--max_gt', '8',
            '--validation_epoch', '0', '--no_interrupt']
    data = (4, ((70, 90), (90, 70)), 1)
    first = run_ranks(W.cli_run, 2, cfg.copy(max_iter=2),
                      [(argv, free_port(), data)], init=False)
    second = run_ranks(W.cli_run, 2, cfg.copy(max_iter=3),
                       [(argv + ['--resume', 'latest'], free_port(), data)],
                       init=False)
    lead, other = (a + b for a, b in zip(first, second))
    for a, b in zip(lead, other):
        assert all(np.array_equal(a['weights'][k], b['weights'][k])
                   for k in a['weights'])
        for x, y in zip(a['steps'], b['steps']):
            assert all(np.array_equal(x['tensors'][k], y['tensors'][k])
                       for k in x['tensors'])
    assert [r[0]['iteration'] for r in (lead, other)] == [2, 2]
    assert [r[1]['start_iter'] for r in (lead, other)] == [2, 2]
    assert [r[1]['step'] for r in (lead, other)] == [3, 3]
    assert lead[0]['path'] and other[0]['path'] is None
    assert lead[1]['path'].endswith('_3.pth')
    assert all(np.isfinite(v) for run in lead for s in run['steps']
               for v in s['losses'].values())
