"""Spatial partitioning of the port (``parallel/mesh.py:make_mesh_2d``, the
row-sharded modules, ``cli/train.py --spatial_split``) on the CPU: gloo
ranks started with ``spawn`` (``tests/torch_parallel_worker.py``), each
running ``tests/torch_spatial_worker.py``, which imports no JAX.

What is held:

* the row fetch and the two gathers against slicing a whole tensor,
  forward and float64 gradients, on 2 and 3 ranks, and on a map of 2 rows
  over 3 ranks (one rank owns none);
* every op geometry of the ResNet configs (the convs, the stem, the pool,
  the FPN's resizes, the protonet's upsample), row-sharded against the
  whole-map op, the same way;
* the DCN sampling and its backward's plain versions at ``row0 > 0``
  against the whole call sliced, in float64, exactly;
* the tiny base (both stems) and plus steps on data 1 x space 2, data 1 x
  space 3 (the small maps have empty shards) and data 2 x space 2 (4
  ranks), against the one-process step in float64 within 1e-6 (as
  ``tests/test_torch_parallel.py`` holds data parallelism, for its reason:
  in float32 a ReLU input within rounding of zero can take another sign in
  one run than the other); float32 only for what is exact: the ranks'
  weights bit-equal, finite losses, a NaN image skipping the step on
  every rank; and two controls that must fail (each rank's own
  batch-norm moments; the head outputs' gather with the other gradient);
* the port's 2-D step and inference against JAX's ``make_mesh_2d`` (data
  2 x space 4 on the conftest's 8 CPU devices), at JAX's own rtol 2e-4
  for the losses;
* ``cli/train.train(['--distributed', '--spatial_split', '2', ...])`` on
  two ranks, then ``--resume latest``;
* every config the port refused before this split covered it (DarkNet,
  VGG, group norm, direct masks, ``'cat'`` and transposed protonet layers,
  an FPN without downsample convs, grid prototypes, prototypes as
  features): a float64 split forward on two ranks against one process
  (``tests/test_torch_spatial_configs.py`` holds their steps); every
  registered config is made of modules the row-sharded wiring runs;
* the refusals that stay: a world size that does not divide by the
  split, a split without ``--distributed``.
"""

import os

import numpy as np
import pytest
import torch

import torch_spatial_worker as W
from test_torch_inputs import (make_train_batch, seed_offsets_state_dict,
                               tiny_darknet_config, tiny_gn_config,
                               tiny_plus_config, tiny_resnet_config,
                               tiny_vgg_config)
from torch_parallel_worker import Ranks, cli_train, free_port, run_ranks
from yolact_tpu_torch.infer import random_state_dict
from yolact_tpu_torch.kernels import dcn
from yolact_tpu_torch.config import MaskType
from yolact_tpu_torch.parallel import mesh as parallel

torch.set_num_threads(2)

B = 4


# ---- the row fetch, the gathers and the op geometries ----------------------

OP_GRIDS = {'S2': (2, 11), 'S3': (3, 11), 'S3_2rows': (3, 2)}
_OPS = {}


def _ops(grid):
    if grid not in _OPS:
        space, height = OP_GRIDS[grid]
        _OPS[grid] = run_ranks(W.ops_run, space, space, height)
    return _OPS[grid]


@pytest.mark.parametrize('grid,name', [
    (grid, name) for grid in OP_GRIDS for name in W.op_cases()
    # an unpadded 3x3 conv has no output row on a map of 2
    if (grid, name) != ('S3_2rows', 'conv3x3_valid')])
def test_row_sharded_op_matches_the_whole_map_op(grid, name):
    """Each rank's output rows are the whole op's rows, and its input
    gradient the whole op's rows of it, in float64 within 1e-12."""
    space, height = OP_GRIDS[grid]
    ranks = _ops(grid)
    whole = W.op_cases(height)[name][0]
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


@pytest.mark.parametrize('grid', list(OP_GRIDS))
def test_fetch_rows_is_the_whole_map_sliced(grid):
    """Rows [lo - 3, hi + 2) of every rank, the fill outside the map; each
    fetched row's gradient lands on its owner."""
    space, height = OP_GRIDS[grid]
    x = W.whole_map(0, W.map_shape(height))
    grad = torch.zeros_like(x)
    for rank, got in enumerate(_ops(grid)):
        lo, hi = parallel.own(height, rank, space)
        rows = range(lo - 3, hi + 2)
        want = torch.full(W.map_shape(len(rows)), -7.0, dtype=x.dtype)
        weight = W.whole_map(2 + rank, W.map_shape(len(rows)))
        for i, g in enumerate(rows):
            if 0 <= g < height:
                want[:, :, i] = x[:, :, g]
                grad[:, :, g] += weight[:, :, i]
        assert np.array_equal(got['fetch']['y'], want.numpy())
    got = np.concatenate([r['fetch']['grad'] for r in _ops(grid)], 2)
    np.testing.assert_allclose(got, grad.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize('grid', list(OP_GRIDS))
def test_bfloat16_rows_travel_bit_for_bit(grid):
    """A bfloat16 map's fetched and gathered rows are its own bits (they
    travel as bytes)."""
    _, height = OP_GRIDS[grid]
    x = W.whole_map(0, W.map_shape(height)).to(torch.bfloat16).float()
    for rank, got in enumerate(_ops(grid)):
        want = got['fetch']['y'].copy()
        inside = want != -7.0
        assert np.array_equal(got['bf16']['fetch'][inside],
                              torch.from_numpy(want[inside]).to(
                                  torch.bfloat16).float().numpy())
        assert np.array_equal(got['bf16']['gather'], x.numpy())


@pytest.mark.parametrize('grid', list(OP_GRIDS))
@pytest.mark.parametrize('how', ['shared', 'own'])
def test_gather_rows_gradients(grid, how):
    """Every rank gets the whole map.  'shared': every rank's loss is the
    same, and each rank's rows get that loss's gradient once; 'own': each
    rank's loss is its own, and each rank's rows get the sum of all."""
    space, height = OP_GRIDS[grid]
    shape = W.map_shape(height)
    ranks = _ops(grid)
    for got in ranks:
        assert np.array_equal(got[how]['y'], W.whole_map(0, shape).numpy())
    want = W.whole_map(3, shape) if how == 'shared' else \
        sum(W.whole_map(4 + r, shape) for r in range(space))
    got = np.concatenate([r[how]['grad'] for r in ranks], 2)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12)


def test_ownership_covers_every_row_once():
    for n in (1, 2, 5, 18, 35, 69, 138, 275):
        for size in (1, 2, 3, 4):
            parts = [parallel.own(n, r, size) for r in range(size)]
            assert parts[0][0] == 0 and parts[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
            assert all(hi >= lo for lo, hi in parts)


# ---- the DCN plain versions from row0 --------------------------------------

@pytest.mark.parametrize('stride', [1, 2])
def test_dcn_plain_from_row0_is_the_whole_call_sliced(stride):
    """Columns and the backward's three gradients of output rows [r0, r1)
    (row0 = r0) against the whole call's rows (its column gradient zero
    elsewhere), float64, exactly."""
    gen = torch.Generator().manual_seed(stride)
    b, cin, h = 2, 5, 13
    ho = dcn.out_size(h, 3, stride, 1, 1)
    x = torch.randn(b, cin, h, h, generator=gen, dtype=torch.float64)
    offset = torch.randn(b, 18, ho, ho, generator=gen,
                         dtype=torch.float64) * 3
    mask = torch.rand(b, 9, ho, ho, generator=gen, dtype=torch.float64)
    g_cols = torch.randn(b * ho * ho, 9 * cin, generator=gen,
                         dtype=torch.float64)
    full = dcn.dcn_columns_plain(x, offset, mask, 3, stride).view(
        b, ho, ho, -1)
    g_full = g_cols.view(b, ho, ho, -1)
    whole = dcn.dcn_col2im_plain(g_cols, x, offset, mask, 3, stride)
    for r0, r1 in ((2, 5), (ho - 1, ho), (0, ho // 2)):
        part = slice(r0, r1)
        sub = [t[:, :, part].contiguous() for t in (offset, mask)]
        cols = dcn.dcn_columns_plain(x, *sub, 3, stride, 1, 1, r0)
        assert torch.equal(cols.view(b, r1 - r0, ho, -1), full[:, part])
        g = g_full[:, part].reshape(-1, 9 * cin)
        got = dcn.dcn_col2im_plain(g, x, *sub, 3, stride, 1, 1, r0)
        zeroed = torch.zeros_like(g_full)
        zeroed[:, part] = g_full[:, part]
        want = dcn.dcn_col2im_plain(zeroed.view(-1, 9 * cin), x, offset,
                                    mask, 3, stride)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-12)
        for a, w in zip(got[1:], want[1:]):
            assert torch.equal(a, w[:, :, part])
        assert not torch.equal(got[0], whole[0])


def test_dcn_rejects_rows_beyond_the_map():
    x = torch.zeros(1, 4, 6, 6)
    offset, mask = torch.zeros(1, 18, 3, 6), torch.zeros(1, 9, 3, 6)
    dcn.dcn_columns_plain(x, offset, mask, row0=3)
    for row0 in (4, -1):
        with pytest.raises(ValueError, match='row0'):
            dcn.dcn_columns_plain(x, offset, mask, row0=row0)


# ---- the train step ----------------------------------------------------------

# name: (config, overrides, world, space, global batch, float64 steps,
#        float32 steps, controls)
CASES = {
    'base_d1s2': (tiny_resnet_config, {}, 2, 2, 2, 2, True, True),
    'plus_d1s2': (tiny_plus_config, {}, 2, 2, 2, 1, False, False),
    'base_s2d_d1s2': (tiny_resnet_config, {'stem_s2d': True}, 2, 2, 2, 1,
                      False, False),
    'base_d1s3': (tiny_resnet_config, {}, 3, 3, 2, 1, False, False),
    'plus_d2s2': (tiny_plus_config, {}, 4, 2, 4, 1, True, False),
}
_RUNS = {}


def _inputs(cfg, batch):
    """Seeded weights (the DCN offset convs at 0.01) and three global
    batches, the third with a NaN pixel in its last image."""
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    if cfg.use_maskiou:
        sd = seed_offsets_state_dict(sd, torch.Generator().manual_seed(1),
                                     w_scale=0.01, b_scale=1.0)
    batches = [make_train_batch(np.random.RandomState(2 + i), cfg, B=batch)
               for i in range(3)]
    batches[2]['image'][-1, 5, 5, 0] = np.nan
    return sd, batches


def _case(name):
    """(config, the one-process float64 run, the ranks' runs)."""
    if name not in _RUNS:
        make, overrides, world, space, batch, steps, f32, controls = \
            CASES[name]
        cfg = make(use_class_balanced_conf=True, **overrides)
        sd, batches = _inputs(cfg, batch)
        ranks = Ranks(W.case_run, world, space, cfg, sd, batches, steps,
                      f32, controls)
        one = W.float64_run(None, None, cfg, sd, batches[:steps])
        _RUNS[name] = (cfg, one, ranks.results())
    return _RUNS[name]


def _rounding_only(cfg, key):
    """A DCN conv's bias before a batch norm on batch statistics: its
    gradient is zero but for rounding (tests/test_torch_parallel.py)."""
    return (not cfg.freeze_bn and cfg.use_maskiou
            and key.endswith('conv2.bias'))


def _worst(cfg, got, want):
    """The largest error of any tensor relative to its largest entry."""
    assert got.keys() == want.keys()
    worst = 0.0
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        if _rounding_only(cfg, k):
            assert err < 1e-4, k
            continue
        worst = max(worst, err / max(float(np.abs(w).max()), 1e-12))
    return worst


@pytest.mark.parametrize('name', list(CASES))
def test_spatial_losses_match_one_process_in_float64(name):
    cfg, one, ranks = _case(name)
    for got in ranks:
        for a, w in zip(got['f64']['steps'], one['steps']):
            assert a.keys() == w.keys()
            for k, v in w.items():
                assert abs(a[k] - v) <= 1e-6 * abs(v), (k, a[k], v)


@pytest.mark.parametrize('name', list(CASES))
def test_spatial_gradients_and_weights_match_one_process_in_float64(name):
    """The first step's gradients, and the weights and running statistics
    after the last, within 1e-6 of each tensor's largest entry."""
    cfg, one, ranks = _case(name)
    for got in ranks:
        assert _worst(cfg, got['f64']['grads'], one['grads']) <= 1e-6
        assert _worst(cfg, got['f64']['weights'], one['weights']) <= 1e-6


@pytest.mark.parametrize('name', [n for n in CASES if CASES[n][6]])
def test_spatial_ranks_stay_bit_equal_in_float32(name):
    """Every rank's weights and buffers are the same bits after every
    step; the losses are finite; the NaN pixel of the third batch (in the
    last data rank's images) skips the step on every rank and leaves the
    weights as they were."""
    _, _, ranks = _case(name)
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


@pytest.mark.parametrize('control', ['local_bn', 'own_gather'])
def test_spatial_controls_fail(control):
    """Each rank's own batch-norm moments, or the head outputs gathered
    with the gradient summed over the ranks, move the step far beyond the
    1e-6 the spatial step keeps."""
    cfg, one, ranks = _case('base_d1s2')
    got = ranks[0]['controls'][control]
    loss_gap = max(abs(got['steps'][0][k] - v) / abs(v)
                   for k, v in one['steps'][0].items())
    grad_gap = _worst(cfg, got['grads'], one['grads'])
    assert max(loss_gap, grad_gap) > 1e-3, (loss_gap, grad_gap)
    if control == 'own_gather':
        assert loss_gap < 1e-6 < grad_gap


# ---- against JAX's 2-D mesh --------------------------------------------------

JAX_GRID = (2, 4)        # data, space


@pytest.fixture(scope='module')
def jax_runs():
    """One set of 8 ranks (the port's data 2 x space 4) for two runs, and
    JAX's on its own data 2 x space 4 mesh and on one device:

    * the step of tiny base with frozen batch norm (JAX's own spatial
      test) from the same weights, batch and draws;
    * inference of tiny base on host-normalized frames (JAX's own spatial
      inference test), the port's ``Pipeline`` against JAX's
      ``forward_and_detect``."""
    import _tiny
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
    jcfg = _tiny.tiny_resnet_config(freeze_bn=True)
    model, jstate = _jax_state(jcfg)
    batch = make_train_batch(np.random.RandomState(0), P(jcfg), B=B)
    key = jax.random.PRNGKey(7)
    p = 3 * sum((128 // s) ** 2 for s in (8, 16, 32, 64, 128))
    draws = jax_draws(key, B, p, jcfg.masks_to_train)
    sd = train_state_to_state_dict(P(jcfg), _numpy(jstate.params),
                                   _numpy(jstate.batch_stats))
    icfg = _tiny.tiny_resnet_config(nms_candidates=256)
    variables = _variables(icfg, False)
    imgs = np.random.RandomState(0).rand(2, icfg.max_size, icfg.max_size,
                                         3).astype(np.float32)
    ranks = Ranks(W.step_and_infer_run, 8, JAX_GRID[1], P(jcfg), sd,
                  [batch], [draws], P(icfg),
                  jax_variables_to_state_dict(P(icfg), variables), imgs)
    mesh = make_mesh_2d(jax.devices()[:8], data=JAX_GRID[0],
                        space=JAX_GRID[1])
    step = jax.jit(lambda s, x, r: jax_train_step(jcfg, model, s, x, r))
    spatial = step(jax.device_put(jstate, replicate(mesh)),
                   shard_batch_spatial(mesh, batch), key)
    one = step(jstate, batch, key)
    detections = jax.jit(lambda v, x: jax_forward_and_detect(
        icfg, JaxYolact(icfg), v, x, preprocess=False))(
            variables, shard_batch_spatial(mesh, jnp.asarray(imgs)))
    return dict(jcfg=jcfg, jstate=jstate, spatial=spatial, one=one,
                detections=detections, ranks=ranks.results())


def test_spatial_step_matches_jax_2d_mesh_losses(jax_runs):
    """Each loss letter within JAX's own rtol 2e-4 of its 2-D mesh step's,
    on every rank; conv1 after the step within its own 2e-6."""
    from test_torch_train import _leaves, _numpy
    from yolact_tpu_torch.convert.from_jax import state_dict_to_train_state
    jnew, jlosses = jax_runs['spatial']
    jstate = jax_runs['jstate']
    old = _numpy(jstate.params), _numpy(jstate.batch_stats)
    key = "['model']['backbone']['conv1']['conv']['kernel']"
    for got in jax_runs['ranks']:
        step = got['step']
        assert step['steps'][0]['finite']
        for k in jlosses:
            np.testing.assert_allclose(step['steps'][0][k], float(jlosses[k]),
                                       rtol=2e-4, err_msg=k)
        params, _ = state_dict_to_train_state(step['weights'][0], *old)
        np.testing.assert_allclose(_leaves(params)[key],
                                   _leaves(jnew.params)[key], rtol=0,
                                   atol=2e-6)


def test_spatial_step_matches_jax_one_device_update(jax_runs):
    """Every parameter after the step within the learning rate times 1e-3
    of its momentum's largest entry plus float32 rounding of JAX's
    ONE-DEVICE step's (tests/test_torch_parallel.py's criterion), and the
    momentum of the FPN's downsample convs within 1e-3 of its largest
    entry: the step is held to JAX's one-device step, not to its 2-D mesh
    step.  (The other momentum buffers are held to the one-process step
    in float64 above: in float32 a ReLU input within rounding of zero
    moves the backbone's by up to 1e-2 here.)"""
    from test_torch_train import _leaves, _numpy
    from yolact_tpu_torch.convert.from_jax import state_dict_to_train_state
    jstate = jax_runs['jstate']
    jnew, jlosses = jax_runs['one']
    old = _numpy(jstate.params), _numpy(jstate.batch_stats)
    got = jax_runs['ranks'][0]['step']
    bufs, _ = state_dict_to_train_state(got['momentum'], *old)
    bufs = {k: v for k, v in _leaves(bufs).items() if v is not None}
    want_bufs = _leaves(jnew.opt_state[1].trace)
    frozen = {k for k in want_bufs if "['bn']" in k}
    assert want_bufs.keys() - frozen == bufs.keys()
    params, _ = state_dict_to_train_state(got['weights'][0], *old)
    params, want_params = _leaves(params), _leaves(jnew.params)
    lr = float(jlosses['lr'])
    downsample = [k for k in bufs if "['downsample_layers_" in k]
    assert len(downsample) == 4
    for k, g in bufs.items():
        w = want_bufs[k]
        tol = max(np.abs(w).max(), 1e-6) * 1e-3
        if k in downsample:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)
        np.testing.assert_allclose(
            params[k], want_params[k], rtol=0, err_msg=k,
            atol=lr * tol + 1e-6 * np.abs(want_params[k]).max())


def test_spatial_inference_matches_jax_2d_mesh(jax_runs):
    """Each data rank's detections on every space rank against JAX's
    2-D mesh forward_and_detect: the same valid slots and classes, scores
    and boxes within 1e-5, masks within 1e-4."""
    from test_torch_pipeline import _assert_outputs_match
    from yolact_tpu_torch.infer import InferenceOutput
    want = jax_runs['detections']
    for rank, got in enumerate(jax_runs['ranks']):
        out = got['infer']
        d = rank // JAX_GRID[1]
        assert bool(out['valid'].any())
        _assert_outputs_match(
            type(want)(*[None if v is None else np.asarray(v)[d:d + 1]
                         for v in want]),
            InferenceOutput(**{k: torch.from_numpy(v)
                               for k, v in out.items()}))


def test_spatial_inference_equals_one_process():
    """tiny plus (DCN blocks, the mask re-scoring) on data 1 x space 2
    against the one-process Pipeline on the same frames, float32: the
    same valid slots and classes, scores and boxes within 1e-5, masks
    and mask scores within 1e-4."""
    cfg = tiny_plus_config(nms_candidates=256)
    sd = seed_offsets_state_dict(
        random_state_dict(cfg, torch.Generator().manual_seed(0)),
        torch.Generator().manual_seed(1))
    imgs = np.random.RandomState(1).rand(2, cfg.max_size, cfg.max_size,
                                         3).astype(np.float32)
    ranks = Ranks(W.infer_run, 2, 2, cfg, sd, imgs)
    want = W.infer_run(None, None, cfg, sd, imgs)
    for got in ranks.results():
        assert got.keys() == want.keys()
        for k in ('valid', 'classes'):
            assert np.array_equal(got[k], want[k]), k
        for k, tol in (('scores', 1e-5), ('boxes', 1e-5), ('masks', 1e-4),
                       ('mask_scores', 1e-4)):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                       err_msg=k)


# ---- cli/train.py --spatial_split --------------------------------------------

@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """Two gloo ranks through ``cli/train.train(['--distributed',
    '--spatial_split', '2', ...])``: one data rank of two space ranks, 4
    iterations of a global batch of 2 from the loader's 2 worker threads
    under the unseeded training augmentation, then ``--resume latest``
    for 2 more (``torch_spatial_worker.cli_run``)."""
    tmp = tmp_path_factory.mktemp('cli_spatial')
    cfg = tiny_resnet_config().copy(name='tinyspatial', lr_warmup_until=0)
    argv = ['--distributed', '--spatial_split', '2', '--cuda=False',
            '--config', cfg.name, '--batch_size', '2', '--no_autoscale',
            '--save_folder', str(tmp / 'w'), '--log_folder',
            str(tmp / 'logs'), '--num_workers', '2', '--max_gt', '8',
            '--validation_epoch', '0', '--no_interrupt', '--stem_s2d']
    data = (4, ((70, 90), (90, 70)), 1)
    first = run_ranks(W.cli_run, 2, cfg.copy(max_iter=4),
                      [(argv, free_port(), data)], init=False)
    second = run_ranks(W.cli_run, 2, cfg.copy(max_iter=6),
                       [(argv + ['--resume', 'latest'], free_port(), data)],
                       init=False)
    return cfg, [a + b for a, b in zip(first, second)]


def test_cli_spatial_split_trains_and_resumes(cli_runs):
    """Rank 0 alone saves; the resumed run starts at 4 and ends at 6; the
    ranks' weights stay bit-equal."""
    _, (lead, other) = cli_runs
    for a, b in zip(lead, other):
        assert all(np.array_equal(a['weights'][k], b['weights'][k])
                   for k in a['weights'])
    assert [r[0]['iteration'] for r in (lead, other)] == [4, 4]
    assert [r[1]['start_iter'] for r in (lead, other)] == [4, 4]
    assert [r[1]['step'] for r in (lead, other)] == [6, 6]
    assert lead[0]['path'] and other[0]['path'] is None
    assert lead[1]['path'].endswith('_6.pth')


def test_cli_spatial_split_steps_both_space_ranks_on_one_batch(cli_runs):
    """The two space ranks' loaders augment on draws of their own (their
    delivered images differ), yet at every step both ranks' forwards take
    the same prepared batch, space rank 0's, with the same draws; and the
    first step's losses are the one-process forward's on that batch from
    the same weights (float32, within 1e-4 relative: phase 10's rule)."""
    from yolact_tpu_torch.train.step import create_train_state, forward_loss
    _, (lead, other) = cli_runs
    assert any(not np.array_equal(a, b) for run in range(2)
               for a, b in zip(lead[run]['loaded'], other[run]['loaded']))
    for run in range(2):
        assert len(lead[run]['steps']) == len(other[run]['steps']) > 0
        for a, b in zip(lead[run]['steps'], other[run]['steps']):
            assert a['tensors'].keys() == b['tensors'].keys()
            for k in a['tensors']:
                assert np.array_equal(a['tensors'][k], b['tensors'][k]), k
            assert all(np.array_equal(x, y)
                       for x, y in zip(a['draws'], b['draws']))
    first = lead[0]['steps'][0]
    state = create_train_state(first['cfg'], device='cpu',
                               state_dict={k: torch.from_numpy(v) for k, v
                                           in first['weights'].items()})
    tensors = {k: torch.from_numpy(v) for k, v in first['tensors'].items()}
    with torch.no_grad():
        want = forward_loss(state, tensors,
                            *(torch.from_numpy(d) for d in first['draws']),
                            num_gts=first['tensors']['num_gts'])
    for got in (lead[0]['steps'][0], other[0]['steps'][0]):
        assert got['losses'].keys() == want.keys()
        for k, v in want.items():
            assert abs(got['losses'][k] - float(v)) <= 1e-4 * abs(float(v)), \
                (k, got['losses'][k], float(v))


def test_cli_spatial_split_refuses_what_it_cannot_run():
    """Three ranks do not divide by a split of 2; one process cannot split
    its image over ranks; both say why."""
    with pytest.raises(RuntimeError, match='does not divide the 3 ranks'):
        run_ranks(cli_train, 3, ['--distributed', '--cuda=False',
                                 '--spatial_split', '2'], init=False)
    from yolact_tpu_torch.cli import train as cli
    with pytest.raises(ValueError, match='--distributed'):
        cli.train(['--cuda=False', '--spatial_split', '2'])


# ---- every config takes the split -------------------------------------------

_FORWARDS = {}

SPLIT_CONFIGS = [
    ('darknet', lambda: tiny_darknet_config()),
    ('vgg', lambda: tiny_vgg_config()),
    ('group norm', lambda: tiny_gn_config()),
    ('direct masks', lambda: tiny_resnet_config(mask_type=MaskType.DIRECT)),
    ("'cat'", lambda: tiny_resnet_config().copy(
        mask_proto_net=(('cat', (((8, 3, (('padding', 1),)),),
                                 ((8, 1, ()),))),))),
    ('transposed', lambda: tiny_resnet_config().copy(
        mask_proto_net=((8, -2, (('stride', 2),)),))),
    ('without downsample convs', lambda: tiny_resnet_config().copy(
        fpn=tiny_resnet_config().fpn.copy(use_conv_downsample=False))),
    ('grid', lambda: tiny_resnet_config(
        mask_proto_use_grid=True, mask_proto_grid_file=_grid_file())),
    ('as_features', lambda: tiny_resnet_config(
        mask_proto_prototypes_as_features=True)),
]


def _grid_file():
    if 'grid' not in _FORWARDS:
        import tempfile

        from test_torch_inputs import write_grid
        _FORWARDS['grid'] = write_grid(os.path.join(
            tempfile.mkdtemp(prefix='spatial_grid_'), 'grid.npy'))
    return _FORWARDS['grid']


def _split_forwards():
    """Every SPLIT_CONFIGS config's float64 eval forward on two ranks
    (data 1 x space 2), one set of ranks for all of them."""
    if 'ranks' not in _FORWARDS:
        cases = [(what, make()) for what, make in SPLIT_CONFIGS]
        _FORWARDS['ranks'] = run_ranks(W.forward_run, 2, 2, cases)
    return _FORWARDS['ranks']


@pytest.mark.parametrize('what,make', SPLIT_CONFIGS)
def test_configs_outside_the_slice_raise_with_their_reason(what, make):
    """Named for when the port refused these configs under a split (every
    config outside the batch-norm ResNets with an FPN of downsample convs
    and plain lincomb prototypes): each now builds a split train state on
    a grid without a process group, and its float64 eval forward on two
    ranks gives both ranks the one-process forward's outputs within
    1e-9 of each output's largest entry."""
    from yolact_tpu_torch.train.step import create_train_state
    cfg = make()
    state = create_train_state(cfg, device='cpu', mesh=_fake_grid())
    assert state.mesh.spatial
    want = W.forward_run(None, None, [(what, cfg)])[what]
    for got in _split_forwards():
        assert got[what].keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(
                got[what][k], w, rtol=0, err_msg=k,
                atol=1e-9 * max(float(np.abs(w).max()), 1e-12))


def _fake_grid():
    """A 2-D mesh's view without a process group (building a state issues
    no collective)."""
    cpu = torch.device('cpu')
    return parallel.Mesh(0, 2, cpu, data=parallel.Mesh(0, 1, cpu),
                         space=parallel.Mesh(0, 2, cpu))


# the row-sharded wiring's leaf modules; a config's other leaves run after
# the gather (SPACE_REPLICATED)
ROW_LEAVES = ('Conv2d', 'ConvTranspose2d', 'BatchNorm2d', 'GroupNorm',
              'ReLU', 'LeakyReLU', 'MaxPool2d', 'InterpolateModule')


def test_the_resnet_configs_are_in_the_slice():
    """Named for when only the ResNet configs took a split: every
    registered model config and ResNet-GN's (the repo registers none), and
    each with the s2d stem where its backbone has one, builds, and every leaf module of it is one the row-sharded
    wiring runs (``models/layers.py:run_rows`` and the modules'
    ``forward_rows``), or one that runs after the gather on every space
    rank alike."""
    from yolact_tpu_torch import config as C
    from yolact_tpu_torch.models.yolact import SPACE_REPLICATED, Yolact
    base, gn = C.get_config('yolact_base'), C.RESNET101_GN_BACKBONE
    models = dict({n: c for n, c in C._CONFIG_REGISTRY.items()
                   if c.backbone is not None},
                  yolact_base_gn=base.copy(backbone=base.backbone.copy(
                      name=gn.name, path=gn.path, type=gn.type,
                      args=gn.args)))
    assert len(models) >= 10
    for name, cfg in models.items():
        cfgs = [cfg]
        if cfg.backbone.type in ('resnet', 'resnet_gn') and \
                cfg.mask_proto_src is not None:
            cfgs.append(cfg.copy(stem_s2d=True))
        for c in cfgs:
            with torch.device('meta'):
                model = Yolact(c)
            for path, m in model.named_modules():
                # containers (an empty Sequential is the identity)
                if next(m.children(), None) is not None or \
                        isinstance(m, torch.nn.Sequential) or \
                        path.split('.')[0] in SPACE_REPLICATED:
                    continue
                assert type(m).__name__ in ROW_LEAVES, (name, path, m)


def test_make_mesh_2d_needs_a_world_that_divides():
    cpu = torch.device('cpu')
    mesh = parallel.Mesh(0, 3, cpu)
    assert parallel.make_mesh_2d(mesh, 1) is mesh
    with pytest.raises(ValueError, match='does not divide the 3 ranks'):
        parallel.make_mesh_2d(mesh, 2)
