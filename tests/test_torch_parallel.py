"""Data parallelism of the port (``yolact_tpu_torch/parallel/mesh.py``, the
data-parallel train step, ``cli/train.py --distributed`` and multi-device
``evaluate_dataset``) on the CPU: two gloo ranks started with ``spawn``
from ``tests/torch_parallel_worker.py`` (which imports no JAX), each rank
a process with torchrun's environment on a free port, every start bounded
by ``torch_parallel_worker.RANK_SECONDS``.

The two-rank step is held to the port's one-process step on the same
global batch of 4 and the same draws (the tiny base and tiny plus
configs, with batch statistics and with ``freeze_bn``, class-balanced
OHEM on).  In float32 the two ranks' weights, buffers, momentum and
gradients are bit-equal after every step, their losses finite, and a NaN
in one image of rank 1 skips the step on both ranks.  The comparisons
with the one-process step are made in float64, on the same weights,
batches and draws (``torch_parallel_worker.float64_steps``): each loss
letter within 1e-6 relative for two steps, every first-step gradient and
the batch-norm running statistics after two steps within 1e-6 of their
tensor's largest entry, and ``conf_state`` equal.  A DCN conv's bias
right before a batch norm on batch statistics has a gradient that is zero
but for rounding (the batch norm subtracts it again), so it is held to
1e-4 absolute instead, as in ``tests/test_torch_train.py``.

Why float64.  The two-rank step sums each batch norm's moments in another
order than the one-process ``F.batch_norm``, so the two float32 steps
differ by rounding; where a ReLU input lies within rounding of zero, one
element takes another sign and every gradient upstream moves by 1e-3 to
1e-1 of its largest entry (as ``tests/test_torch_train.py`` found against
JAX).  With frozen batch norm the DCN blocks do the same: their column
GEMM over a batch of 2 rounds otherwise than over 4, and offset convs at
0.1 amplify it.  Whether a sign flips depends on how the machine's oneDNN
rounds the convolutions, so no batch seed keeps a float32 comparison
steady on every CPU (seed 3 of the plus case flipped one on another
machine).  In float64 an input within rounding of zero is about 1e-9 times
as likely, and the two steps agree within 1e-6 whatever the machine: the
float32 comparisons that remain (the ranks with each other) are
bit-exact by construction.  The float64 comparison also holds at batch
seeds where the float32 steps do take another sign (0 for base, 4 for
plus; ``test_float64_two_rank_step_equals_one_process_step``).  (Neither
float32 step is the float64 one within 1e-4: on the tiny configs a few
ReLU inputs of every batch lie within float32 rounding of zero.)

Against JAX: the port's two-rank step against JAX's ``train_step`` on a
2-device mesh (``make_mesh(jax.devices()[:2])``; the conftest gives 8
virtual CPU devices) from the same weights, batch and ``jax.random``
draws, under ``tests/test_torch_train.py``'s tolerances and inputs (its
two-pass-variance flax for batch statistics).
"""

import collections
import json
import os

import numpy as np
import pytest
import torch

from test_torch_inputs import (OraclePipeline, SyntheticEvalSet,
                               make_train_batch, seed_offsets_state_dict,
                               tiny_plus_config, tiny_resnet_config)
from test_torch_train import two_pass_variance  # noqa: F401 (a fixture)
from torch_parallel_worker import (Ranks, case_run, cli_train,
                                   float64_grads, free_port, loss_share,
                                   rank_env, run_ranks, train_cli_runs,
                                   train_steps)
from yolact_tpu_torch.eval import evaluate
from yolact_tpu_torch.infer import random_state_dict
from yolact_tpu_torch.parallel import mesh as parallel

torch.set_num_threads(2)

B = 4
# name: (config, overrides, batch seed, DCN offset-conv weight scale)
CASES = {
    'base': (tiny_resnet_config, {}, 2, None),
    'plus': (tiny_plus_config, {}, 3, 0.01),
    'base_frozen_bn': (tiny_resnet_config, {'freeze_bn': True}, 0, None),
    'plus_frozen_bn': (tiny_plus_config, {'freeze_bn': True}, 1, 0.1),
}
# batch seeds where the float32 steps take another ReLU sign somewhere (on
# the machine where they were found)
SIGN_FLIP_SEEDS = {'base': 0, 'plus': 4}
NAN_ROW = 3                             # an image of rank 1


def _inputs(name, seed=None):
    """(config, state dict, three global batches; the third with a NaN
    pixel in image NAN_ROW)."""
    make, overrides, case_seed, w_scale = CASES[name]
    seed = case_seed if seed is None else seed
    cfg = make(use_class_balanced_conf=True, **overrides)
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    if w_scale is not None:
        sd = seed_offsets_state_dict(sd, torch.Generator().manual_seed(1),
                                     w_scale=w_scale, b_scale=1.0)
    batches = [make_train_batch(np.random.RandomState(seed + i), cfg, B=B)
               for i in range(3)]
    batches[2]['image'][NAN_ROW, 5, 5, 0] = np.nan
    return cfg, sd, batches


_RUNS = {}


def _case(name):
    """(config, one-process run, the two ranks' runs), each with its
    float32 steps and its float64 first two steps; computed once a
    module."""
    if name not in _RUNS:
        cfg, sd, batches = _inputs(name)
        ranks = Ranks(case_run, 2, cfg, sd, batches)
        one = case_run(None, cfg, sd, batches)       # while the ranks run
        _RUNS[name] = (cfg, one, ranks.results())
    return _RUNS[name]


def _rounding_only(cfg, name):
    """A DCN bias before a batch norm on batch statistics (see the module
    docstring)."""
    return (not cfg.freeze_bn and cfg.use_maskiou
            and name.endswith('conv2.bias'))


def _hold(cfg, got, want, rel, what):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        if _rounding_only(cfg, k):
            assert err < 1e-4, (what, k, err)
            continue
        top = max(float(np.abs(w).max()), 1e-12)
        assert err <= rel * top, (what, k, err, top)


@pytest.mark.parametrize('name', list(CASES))
def test_two_rank_losses_match_one_process(name):
    """Two steps in float64: each loss within 1e-6 relative on both ranks;
    the float32 ranks' losses finite and equal."""
    cfg, one, two = _case(name)
    for i in (0, 1):
        want = one['f64']['steps'][i]
        for rank, run in enumerate(two):
            got = run['f64']['steps'][i]
            assert got.keys() == want.keys() and got['finite']
            assert got['lr'] == want['lr']
            for k in want.keys() - {'finite', 'lr'}:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           err_msg=f'step {i} rank {rank} {k}')
        f32 = [run['train']['steps'][i] for run in two]
        assert f32[0] == f32[1] and f32[0]['finite']
        assert all(np.isfinite(v) for k, v in f32[0].items()
                   if k not in ('finite', 'lr'))


@pytest.mark.parametrize('name', list(CASES))
def test_two_rank_gradients_match_one_process(name):
    """The first step's gradients: in float64 within 1e-6 of each
    tensor's largest entry; in float32 the same bits on both ranks."""
    cfg, one, two = _case(name)
    _hold(cfg, two[0]['f64']['grads'], one['f64']['grads'], 1e-6,
          'first-step gradients')
    g0, g1 = (run['train']['grads'] for run in two)
    assert g0.keys() == one['train']['grads'].keys()
    assert all(np.array_equal(g0[k], g1[k]) for k in g0)
    if cfg.freeze_bn:      # frozen batch norm is never trained
        assert not any('.bn' in k for k in g0)


@pytest.mark.parametrize('name', list(CASES))
def test_two_ranks_stay_bit_equal(name):
    """Weights and buffers after every step, the momentum and conf_state
    after the last: the same bits on both ranks."""
    _, _, two = _case(name)
    a, b = (run['train'] for run in two)
    for step, (wa, wb) in enumerate(zip(a['weights'], b['weights'])):
        assert wa.keys() == wb.keys()
        for k in wa:
            assert np.array_equal(wa[k], wb[k]), (step, k)
    assert a['momentum'].keys() == b['momentum'].keys() and a['momentum']
    assert all(np.array_equal(a['momentum'][k], b['momentum'][k])
               for k in a['momentum'])
    assert all(np.array_equal(a['conf_state'][k], b['conf_state'][k])
               for k in a['conf_state'])


@pytest.mark.parametrize('name', list(CASES))
def test_batch_norm_statistics_and_conf_state_match_one_process(name):
    """After two float64 steps: the running statistics within 1e-6 of each
    tensor's largest entry and ``conf_state`` equal (frozen batch norm
    keeps 0 and 1 in float32 too)."""
    cfg, one, two = _case(name)
    want, got = one['f64']['weights'][1], two[0]['f64']['weights'][1]
    stats = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    assert stats
    _hold(cfg, {k: got[k] for k in stats}, {k: want[k] for k in stats},
          1e-6, 'running statistics')
    if cfg.freeze_bn:
        f32 = two[0]['train']['weights'][1]
        for k in stats:
            assert np.all(f32[k] == (0.0 if k.endswith('mean') else 1.0))
    for k, v in one['f64']['conf_state'].items():
        assert np.array_equal(two[0]['f64']['conf_state'][k], v), k
    assert float(one['f64']['conf_state']['total']) > 0


@pytest.mark.parametrize('name', list(CASES))
def test_nan_on_one_rank_skips_the_step_on_both(name):
    """The third batch has a NaN pixel in an image of rank 1 only: both
    ranks (and the one-process step) skip it, their weights and buffers
    those of the step before, bit for bit."""
    _, one, two = _case(name)
    for run in [one] + two:
        run = run['train']
        step = run['steps'][2]
        assert not step['finite'] and not np.isfinite(step['total'])
        before, after = run['weights'][1], run['weights'][2]
        assert all(np.array_equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize('name,flip', [('base', False), ('base', True),
                                       ('plus', False), ('plus', True)],
                         ids=['base', 'base_sign_flip', 'plus',
                              'plus_sign_flip'])
def test_float64_two_rank_step_equals_one_process_step(name, flip):
    """The first step in float64, batch statistics, at the case's batch
    seed and at one where the float32 steps take another ReLU sign
    somewhere: each loss within 1e-12 relative, every gradient within 1e-6
    of its largest entry, the ranks' gradients bit-equal."""
    if flip:
        cfg, sd, batches = _inputs(name, seed=SIGN_FLIP_SEEDS[name])
        ranks = Ranks(float64_grads, 2, cfg, sd, batches[0])
        one = float64_grads(None, cfg, sd, batches[0])
        two = ranks.results()
    else:
        cfg, one, two = _case(name)
        one, two = one['f64'], [run['f64'] for run in two]
    for k, v in one['losses'].items():
        for run in two:
            np.testing.assert_allclose(run['losses'][k], v, rtol=1e-12,
                                       err_msg=k)
    _hold(cfg, two[0]['grads'], one['grads'], 1e-6, 'float64 gradients')
    assert all(np.array_equal(two[0]['grads'][k], two[1]['grads'][k])
               for k in one['grads'])


@pytest.mark.parametrize('name', ['base', 'plus'])
def test_world_size_one_is_the_one_process_step(name):
    """A process group of one rank runs no collective: the step is
    ``train_step``'s, bit for bit."""
    cfg, sd, batches = _inputs(name)
    one = _case(name)[1]['train']
    (got,) = run_ranks(train_steps, 1, cfg, sd, batches)
    np.testing.assert_equal(got['steps'], one['steps'])    # NaN == NaN
    for key in ('grads', 'momentum', 'conf_state'):
        assert got[key].keys() == one[key].keys()
        assert all(np.array_equal(got[key][k], one[key][k])
                   for k in one[key]), key
    for a, b in zip(got['weights'], one['weights']):
        assert all(np.array_equal(a[k], b[k]) for k in b)


# ---- the loss over the global batch ---------------------------------------

@pytest.fixture(scope='module')
def loss_case():
    """The loss alone on seeded network outputs of the tiny plus config
    with every batch reduction on (class-balanced OHEM, the l1 prototype
    loss, class existence, semantic segmentation, the mask-IoU cap at
    masks_to_train 4 over maskious_to_train 3), a conf_state that does
    not start at 0: (config, one-process result, the two ranks')."""
    from yolact_tpu_torch.models.yolact import Yolact
    from yolact_tpu_torch.train.step import draw_priorities, model_input
    cfg = tiny_plus_config(use_class_balanced_conf=True, mask_proto_loss='l1',
                           use_class_existence_loss=True, masks_to_train=4,
                           maskious_to_train=3)
    model = Yolact(cfg)
    model.load_state_dict(random_state_dict(
        cfg, torch.Generator().manual_seed(0)))
    batch = make_train_batch(np.random.RandomState(1), cfg, B=B)
    with torch.no_grad():
        preds = model(model_input(cfg, torch.as_tensor(batch['image'])),
                      train=True)
    preds = {k: v.numpy() for k, v in preds.items()}
    mask_pri, miou_pri = (d.numpy() for d in draw_priorities(
        cfg, B, preds['priors'].shape[0], torch.Generator().manual_seed(5),
        'cpu'))
    c = cfg.num_classes
    conf = {'class_counts': np.arange(c, dtype=np.float32),
            'total': np.float32(c * (c - 1) / 2)}
    args = (cfg, preds, batch, mask_pri, miou_pri, conf)
    return cfg, loss_share(None, *args), run_ranks(loss_share, 2, *args)


def test_loss_shares_sum_to_the_global_batch_loss(loss_case):
    _, one, two = loss_case
    assert set(one['losses']) == {'B', 'M', 'C', 'P', 'E', 'S'}
    for k, v in one['losses'].items():
        got = sum(run['losses'][k] for run in two)
        np.testing.assert_allclose(got, v, rtol=1e-6, err_msg=k)


def test_maskiou_cap_takes_the_same_slots_across_ranks(loss_case):
    """The cap keeps masks_to_train of the valid slots of the whole batch
    (more than maskious_to_train were valid), and the kept slots lie on
    both ranks: each rank keeps its rows of the one-process choice."""
    cfg, one, two = loss_case
    got = np.concatenate([run['valid'] for run in two])
    np.testing.assert_array_equal(got, one['valid'])
    assert one['valid'].sum() == cfg.masks_to_train > cfg.maskious_to_train
    assert all(run['valid'].any() for run in two)


def test_class_balanced_counts_are_the_global_batch_counts(loss_case):
    _, one, two = loss_case
    for run in two:
        for k, v in one['conf_state'].items():
            assert np.array_equal(run['conf_state'][k], v), k


# ---- against JAX's 2-device mesh ------------------------------------------

# name: (JAX config, overrides, batch seed, offset-conv scale):
# test_torch_train.py's inputs, a batch of 2 (one image per rank)
JAX_CASES = {
    'base': ('tiny_resnet_config', {}, 4, 0.1),
    'base_frozen_bn': ('tiny_resnet_config', {'freeze_bn': True}, 0, 0.1),
    'plus_frozen_bn': ('tiny_plus_config', {'freeze_bn': True}, 0, 0.1),
}


@pytest.mark.parametrize('name', list(JAX_CASES))
def test_two_rank_step_matches_jax_mesh_step(name, request):
    """One step: each loss letter within 1e-4 relative, every momentum
    buffer (the gradient plus weight decay) within 1e-3 of its largest
    entry, every parameter within the learning rate times that plus
    float32 rounding, the running statistics within 1e-4."""
    import _tiny
    import jax
    from test_torch_loss import jax_draws
    from test_torch_train import _jax_state, _leaves, _numpy
    from yolact_tpu.parallel.mesh import make_mesh, replicate
    from yolact_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from yolact_tpu.train.step import train_step as jax_train_step
    from yolact_tpu_torch.convert.from_jax import config_from_jax as P
    from yolact_tpu_torch.convert.from_jax import (state_dict_to_train_state,
                                                   train_state_to_state_dict)
    make, overrides, seed, w_scale = JAX_CASES[name]
    b = 2
    jcfg = getattr(_tiny, make)(**overrides)
    if not jcfg.freeze_bn:
        request.getfixturevalue('two_pass_variance')
    model, jstate = _jax_state(jcfg, w_scale=w_scale)
    batch = make_train_batch(np.random.RandomState(seed), P(jcfg), B=b)
    key = jax.random.PRNGKey(7)
    p = 3 * sum((128 // s) ** 2 for s in (8, 16, 32, 64, 128))
    draws = jax_draws(key, b, p, jcfg.masks_to_train)
    mesh = make_mesh(jax.devices()[:2])
    jnew, jlosses = jax.jit(
        lambda s, x, r: jax_train_step(jcfg, model, s, x, r))(
            jax.device_put(jstate, replicate(mesh)),
            jax_shard_batch(mesh, batch), key)
    old = _numpy(jstate.params), _numpy(jstate.batch_stats)
    sd = train_state_to_state_dict(P(jcfg), *old)
    two = run_ranks(train_steps, 2, P(jcfg), sd, [batch], 0, [draws])
    got = two[0]
    assert got['steps'][0]['finite']
    for k in jlosses:
        np.testing.assert_allclose(got['steps'][0][k], float(jlosses[k]),
                                   rtol=1e-4, err_msg=k)
    bufs, _ = state_dict_to_train_state(got['momentum'], *old)
    bufs = {k: v for k, v in _leaves(bufs).items() if v is not None}
    want_bufs = _leaves(jnew.opt_state[1].trace)
    frozen = {k for k in want_bufs if jcfg.freeze_bn and "['bn']" in k}
    assert want_bufs.keys() - frozen == bufs.keys()
    params, stats = state_dict_to_train_state(got['weights'][0], *old)
    params, want_params = _leaves(params), _leaves(jnew.params)
    lr = float(jlosses['lr'])
    for k, g in bufs.items():
        w = want_bufs[k]
        if "['conv2']['bias']" in k and not jcfg.freeze_bn:
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-4, k
            continue
        tol = max(np.abs(w).max(), 1e-6) * 1e-3
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)
        np.testing.assert_allclose(
            params[k], want_params[k], rtol=0, err_msg=k,
            atol=lr * tol + 1e-6 * np.abs(want_params[k]).max())
    for k, v in _leaves(stats).items():
        np.testing.assert_allclose(v, _leaves(jnew.batch_stats)[k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)


# ---- cli/train.py --distributed -------------------------------------------

@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """Two gloo ranks through ``cli/train.train(['--distributed', ...])``:
    10 iterations of a global batch of 4 (2 per rank, so freeze_bn), then
    ``--resume latest`` for 2 more.  Returns (save folder, log folder,
    config name, each rank's two runs)."""
    root = tmp_path_factory.mktemp('dist')
    name = 'tinydist'
    cfg = tiny_resnet_config().copy(name=name, lr_warmup_until=0)
    save, logs = str(root / 'w'), str(root / 'logs')
    argv = ['--distributed', '--cuda=False', '--config', name,
            '--batch_size', str(B), '--no_autoscale', '--save_folder', save,
            '--log_folder', logs, '--num_workers', '1', '--max_gt', '8',
            '--validation_epoch', '0', '--no_interrupt']
    data = (8, ((70, 90), (90, 70), (80, 80)), 1)
    runs = [(argv, free_port(), data, None),
            (argv + ['--resume', 'latest'], free_port(), data, None)]
    configs = [cfg.copy(max_iter=10), cfg.copy(max_iter=12)]
    first = run_ranks(train_cli_runs, 2, configs[:1], runs[:1], init=False)
    second = run_ranks(train_cli_runs, 2, configs[1:], runs[1:], init=False)
    return save, logs, name, [a + b for a, b in zip(first, second)]


def test_cli_distributed_rank0_alone_saves_and_logs(cli_runs):
    save, logs, name, ranks = cli_runs
    lead, other = ranks
    assert lead[0]['iteration'] == other[0]['iteration'] == 10
    assert lead[0]['path'] and other[0]['path'] is None
    assert lead[0]['log'] and other[0]['log'] is None
    losses = [[e['loss'] for e in run[0]['losses']] for run in ranks]
    assert losses[0] and losses[0] == losses[1]
    assert all(np.isfinite(v) for e in losses[0] for v in e.values())
    assert sorted(os.listdir(save)) == sorted(
        os.path.basename(r['path']) for r in lead)
    assert os.listdir(logs) == [f'{name}.log']
    with open(os.path.join(logs, f'{name}.log')) as f:
        kinds = collections.Counter(json.loads(line)['type'] for line in f)
    assert kinds == {'session': 2, 'train': 1}
    w0, w1 = lead[0]['weights'], other[0]['weights']
    assert all(np.array_equal(w0[k], w1[k]) for k in w0)


def test_cli_distributed_resume_latest_continues_on_both_ranks(cli_runs):
    _, _, _, ranks = cli_runs
    for run in ranks:
        assert run[1]['start_iter'] == 10 and run[1]['iteration'] == 12
        assert run[1]['step'] == 12
    w0, w1 = ranks[0][1]['weights'], ranks[1][1]['weights']
    assert all(np.array_equal(w0[k], w1[k]) for k in w0)
    assert any(not np.array_equal(w0[k], ranks[0][0]['weights'][k])
               for k in w0)


def test_cli_distributed_batch_must_divide_over_the_ranks():
    """A global batch of 3 over 2 ranks: both refuse, saying how JAX
    differs."""
    with pytest.raises(RuntimeError, match='does not divide over 2 ranks'):
        run_ranks(cli_train, 2, ['--distributed', '--cuda=False',
                                 '--batch_size', '3'], init=False)


# ---- mesh.py --------------------------------------------------------------

def test_shard_batch_takes_the_rank_rows():
    batch = {'image': np.arange(8)[:, None] * np.ones((1, 3)),
             'num_gts': torch.arange(8), 'note': 'kept'}
    for rank in range(4):
        got = parallel.shard_batch(batch, rank, 4)
        np.testing.assert_array_equal(got['image'][:, 0],
                                      [2 * rank, 2 * rank + 1])
        assert got['num_gts'].tolist() == [2 * rank, 2 * rank + 1]
        assert got['note'] == 'kept'
    with pytest.raises(ValueError, match='divide'):
        parallel.shard_batch(batch, 0, 3)


def test_init_from_env_refuses_what_it_cannot_start():
    with pytest.raises(RuntimeError, match='RANK'):
        parallel.init_from_env('gloo', env={})
    env = rank_env(0, 1, free_port())
    with pytest.raises(ValueError, match='backend'):
        parallel.init_from_env('mpi', env=env)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            parallel.init_from_env('nccl', env=env)
        with pytest.raises(RuntimeError, match='cuda'):
            parallel.init_from_env('gloo', device='cuda:0', env=env)
    with pytest.raises(ValueError, match='CUDA'):
        parallel.init_from_env('nccl', device='cpu', env=env)
    assert not torch.distributed.is_initialized()


def test_spatial_split_raises_with_its_reason():
    mesh = parallel.Mesh(0, 1, torch.device('cpu'))
    assert parallel.make_mesh_2d(mesh, 1) is mesh
    with pytest.raises(NotImplementedError, match='halo'):
        parallel.make_mesh_2d(mesh, 2)


# ---- multi-device evaluation ----------------------------------------------

@pytest.mark.parametrize('fast_nms', [True, False],
                         ids=['fast_nms', 'traditional'])
def test_evaluate_on_two_devices_equals_one(fast_nms, capsys):
    """Random weights, 5 frames, eval_batch_size 3: on two devices (the
    CPU standing for both) the batch rounds up to 4, and the mAP table and
    the detections written equal the one-device run's."""
    cfg = tiny_resnet_config()
    sd = random_state_dict(cfg, torch.Generator().manual_seed(0))
    data = SyntheticEvalSet(5, cfg.max_size, cfg.num_classes, seed=2)
    kw = dict(eval_batch_size=3, fast_nms=fast_nms, no_bar=True)
    one = evaluate.evaluate_dataset(cfg, sd, data, 'cpu', quiet=True, **kw)
    capsys.readouterr()
    two = evaluate.evaluate_dataset(cfg, sd, data, 'cpu', n_devices=2, **kw)
    assert 'eval_batch_size 3 not divisible by 2 devices; using 4' in \
        capsys.readouterr().out
    assert two == one


@pytest.mark.parametrize('n_devices,batch', [(2, 3), (2, 4), (3, 1)])
def test_evaluate_replicas_on_detections_from_the_gt(monkeypatch, n_devices,
                                                     batch):
    """Every replica answering its slice from the gt: a non-zero mAP table,
    equal to the one-device table, the batch rounded up."""
    cfg = tiny_resnet_config()
    data = SyntheticEvalSet(7, cfg.max_size, cfg.num_classes, seed=4)
    sizes = []

    class Oracle(OraclePipeline):
        def __call__(self, images):
            sizes.append(len(images))
            return super().__call__(images)

    monkeypatch.setattr(evaluate, 'Pipeline',
                        lambda *a, **k: Oracle(data, cfg, (32, 32)))
    one = evaluate.evaluate_dataset(cfg, {}, data, 'cpu', quiet=True,
                                    eval_batch_size=batch)
    sizes.clear()
    two = evaluate.evaluate_dataset(cfg, {}, data, 'cpu', quiet=True,
                                    eval_batch_size=batch,
                                    n_devices=n_devices)
    rounded = -(-batch // n_devices) * n_devices
    assert set(sizes) == {rounded // n_devices}
    assert two == one and one['mask']['all'] > 0 and one['box']['all'] > 0


def test_eval_devices_beyond_the_cards_raise():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; this checks the no-GPU error')
    with pytest.raises(RuntimeError, match='cuda'):
        evaluate.eval_devices('cuda', 2)
    assert evaluate.eval_devices('cpu', 0) == [torch.device('cpu')]
    assert evaluate.eval_devices('cpu', 3) == [torch.device('cpu')] * 3
