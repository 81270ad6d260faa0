"""The rank side of ``tests/test_torch_parallel.py``: starting gloo ranks
with the ``spawn`` start method, and what each rank runs.  It imports
nothing of JAX (a spawned rank imports this module, not the test file):
the port, torch, numpy and the port-side inputs of ``test_torch_inputs``.

:func:`run_ranks` starts ``world`` processes on a free port, each with
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), and returns each rank's result in rank
order; a rank that raises fails the call with its traceback, and a run
past its time limit kills every rank and raises.  :class:`Ranks` starts
them and lets the caller work while they run.  Results travel as numpy
arrays and plain Python values."""

from __future__ import annotations

import os
import queue
import socket
import traceback

import numpy as np
import torch

RANK_SECONDS = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))


def _rank_main(fn, rank, world, port, args, init, threads, results):
    os.environ.update(rank_env(rank, world, port))
    torch.set_num_threads(threads)      # the caller's: the same rounding
    from yolact_tpu_torch.parallel import mesh as parallel
    try:
        mesh = parallel.init_from_env('gloo') if init else None
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        parallel.destroy()


class Ranks:
    """`world` spawned ranks running ``fn(mesh, *args)`` (``mesh`` None
    when `init` is False: `fn` starts the process group itself); the
    caller may work meanwhile, then :meth:`results` waits for them."""

    def __init__(self, fn, world, *args, init=True, seconds=RANK_SECONDS):
        import multiprocessing as mp
        ctx = mp.get_context('spawn')
        self.world, self.seconds = world, seconds
        self.queue = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, rank, world, port, args, init,
                                        torch.get_num_threads(), self.queue))
                      for rank in range(world)]
        for p in self.procs:
            p.start()

    def results(self):
        """The results in rank order; a rank that raised fails the call
        with its traceback, and a run past its time limit kills every rank
        and raises."""
        world, got = self.world, {}
        try:
            while len(got) < world:
                try:
                    rank, ok, value = self.queue.get(timeout=self.seconds)
                except queue.Empty:
                    raise TimeoutError(
                        f'ranks {sorted(set(range(world)) - set(got))} gave '
                        f'no result in {self.seconds} s')
                if not ok:
                    raise RuntimeError(f'rank {rank} failed:\n{value}')
                got[rank] = value
            for p in self.procs:
                p.join(timeout=30)
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [got[r] for r in range(world)]


def run_ranks(fn, world, *args, init=True, seconds=RANK_SECONDS):
    """``fn(mesh, *args)`` on `world` spawned ranks (:class:`Ranks`); the
    results in rank order."""
    return Ranks(fn, world, *args, init=init, seconds=seconds).results()


def _numpy(tensors):
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def train_steps(mesh, cfg, state_dict, batches, seed=0, draws=None):
    """A train state from `state_dict` on the CPU (data parallel over
    `mesh`, or one process when it is None), one ``train_step`` per global
    batch of `batches` on this rank's rows, the draws from a generator
    seeded `seed` (or, per step, the given global ``(mask_priorities,
    maskiou_priorities)``).  Per step: the losses and whether the update was
    applied; the first step's gradients; and after the last step the
    weights and buffers, the momentum and ``conf_state``."""
    from yolact_tpu_torch.parallel.mesh import shard_batch
    from yolact_tpu_torch.train.step import (apply_gradients,
                                             create_train_state,
                                             loss_and_grads, train_step)
    state = create_train_state(cfg, device='cpu', state_dict=state_dict,
                               mesh=mesh)
    generator = torch.Generator().manual_seed(seed)
    steps, grads, weights = [], None, []
    for i, batch in enumerate(batches):
        if mesh is not None:
            batch = shard_batch(batch, mesh.rank, mesh.size)
        if draws is None:
            out = train_step(state, batch, generator)
        else:
            mask_pri, miou_pri = (torch.as_tensor(d) for d in draws[i])
            if mesh is not None:
                mask_pri = mask_pri[mesh.rows(mask_pri.shape[0])]
            out = apply_gradients(state, loss_and_grads(
                state, batch, mask_pri, miou_pri))
        steps.append(dict({k: float(v) for k, v in out.items()
                           if k not in ('finite', 'lr')},
                          finite=out['finite'], lr=out['lr']))
        if grads is None:
            grads = _numpy({k: p.grad for k, p in
                            state.model.named_parameters()
                            if p.grad is not None})
        weights.append(_numpy(state.model.state_dict()))
    momentum = _numpy({k: state.optimizer.state[p]['momentum_buffer']
                       for k, p in state.model.named_parameters()
                       if p in state.optimizer.state})
    conf = None if state.conf_state is None else _numpy(state.conf_state)
    return dict(steps=steps, grads=grads, weights=weights,
                momentum=momentum, conf_state=conf)


def loss_share(mesh, cfg, preds, batch, mask_pri, miou_pri, conf_state):
    """``multibox_loss`` on this rank's rows of `preds` and `batch` (the
    whole batch when `mesh` is None), the maskiou net left out: the loss
    letters (the rank's shares), the valid mask-IoU slots of the rank's
    rows and ``conf_state``."""
    from yolact_tpu_torch.parallel.mesh import shard_batch
    from yolact_tpu_torch.train import loss as loss_module
    targets = {}
    real = loss_module.lincomb_mask_loss

    def lincomb(*a, **k):
        out = real(*a, **k)
        targets['valid'] = out[1].valid.numpy().copy()
        return out

    loss_module.lincomb_mask_loss = lincomb
    try:
        if mesh is not None:
            preds = dict(shard_batch({k: v for k, v in preds.items()
                                      if k != 'priors'}, mesh.rank,
                                     mesh.size), priors=preds['priors'])
            batch = shard_batch(batch, mesh.rank, mesh.size)
            mask_pri = mask_pri[mesh.rows(mask_pri.shape[0])]
        preds = {k: torch.as_tensor(v) for k, v in preds.items()}
        tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
        conf = {k: torch.as_tensor(v) for k, v in conf_state.items()}
        losses, _ = loss_module.multibox_loss(
            cfg, preds, tensors, torch.as_tensor(mask_pri),
            torch.as_tensor(miou_pri), conf_state=conf,
            num_gts=batch['num_gts'], mesh=mesh)
    finally:
        loss_module.lincomb_mask_loss = real
    new_conf = losses.pop('_conf_state')
    return dict(losses={k: float(v) for k, v in losses.items()},
                valid=targets['valid'], conf_state=_numpy(new_conf))


def train_cli_runs(mesh, configs, runs):
    """``cli/train.train`` once per ``(argv, port, dataset_args, val_args)``
    of `runs`, in turn, after registering `configs` in this rank's registry
    (a spawned rank starts with the built-in configs only).  The run starts
    its own process group on `port` (``mesh`` is None: the ranks start
    without one).  Training data: ``test_torch_inputs.SyntheticTrainSet(n,
    sizes, ...)`` with a seeded augmentation, from ``dataset_args = (n,
    sizes, seed)``; validation: ``SyntheticEvalSet(*val_args)`` or none.
    Per run: the summary's iteration, start, checkpoint path, log path,
    logged losses, maps and step, and the weights."""
    from test_torch_inputs import SyntheticEvalSet, SyntheticTrainSet
    from yolact_tpu_torch.cli import train as cli
    from yolact_tpu_torch.config import get_config, register_config
    from yolact_tpu_torch.data.augmentations import SSDAugmentation
    for cfg in configs:
        register_config(cfg)
    out = []
    for argv, port, (n, sizes, seed), val_args in runs:
        os.environ['MASTER_PORT'] = str(port)
        cfg = get_config(argv[argv.index('--config') + 1])
        data = SyntheticTrainSet(n, sizes, cfg.num_classes, SSDAugmentation(
            cfg, rng=np.random.RandomState(seed)), seed=seed)
        val = None if val_args is None else SyntheticEvalSet(
            val_args[0], cfg.max_size, cfg.num_classes, seed=val_args[1])
        run = cli.train(argv, dataset=data, val_dataset=val)
        out.append(dict(iteration=run['iteration'],
                        start_iter=run['start_iter'], path=run['path'],
                        log=run['log'], losses=run['losses'],
                        maps=run['maps'], step=run['state'].step,
                        weights=_numpy(run['state'].model.state_dict())))
    return out


def cli_train(mesh, argv):
    """``cli/train.train(argv)`` with no data (for flags it refuses)."""
    from yolact_tpu_torch.cli import train as cli
    return cli.train(argv)


def float64_steps(mesh, cfg, state_dict, batches, seed=0):
    """:func:`train_steps` in float64: one step per global batch of
    `batches` (the forward, the loss, the backward and the gradients' sum
    over ranks of ``train/step.py:loss_and_grads``, with ``.float()``
    meaning float64, as ``tests/test_torch_train.py:_float64_grads`` runs
    the port; then ``apply_gradients``), the draws from a generator seeded
    `seed` as ``train_step`` draws them.  The same keys as
    :func:`train_steps`, and the first step's ``losses``.  In float64 no
    ReLU input lies within rounding of zero in one run and not another, so
    two runs of the same math agree to far below any sign flip's effect on
    any machine."""
    from yolact_tpu_torch.parallel.mesh import shard_batch
    from yolact_tpu_torch.train.loss import multibox_loss
    from yolact_tpu_torch.train.step import (apply_gradients,
                                             batch_to_device,
                                             create_train_state,
                                             draw_priorities, model_input)
    state = create_train_state(cfg, device='cpu', state_dict=state_dict,
                               mesh=mesh)
    model = state.model.double()
    model.compute_dtype = torch.float64
    if state.conf_state is not None:
        state.conf_state = {k: v.double()
                            for k, v in state.conf_state.items()}
    params = [p for group in state.optimizer.param_groups
              for p in group['params']]
    priors = model.priors(cfg.max_size, cfg.max_size, 'cpu')
    generator = torch.Generator().manual_seed(seed)
    steps, grads, weights = [], None, []
    for batch in batches:
        n = len(batch['image'])
        mask_pri, miou_pri = (d.double() for d in draw_priorities(
            cfg, n, priors.shape[0], generator, 'cpu'))
        if mesh is not None:
            batch = shard_batch(batch, mesh.rank, mesh.size)
            mask_pri = mask_pri[mesh.rows(n)]
        state.optimizer.zero_grad(set_to_none=True)
        real_float = torch.Tensor.float
        torch.Tensor.float = torch.Tensor.double
        try:
            tensors = batch_to_device(
                dict(batch, image=batch['image'].astype(np.float64)), 'cpu')
            preds = model(model_input(cfg, tensors['image']), train=True)
            losses, _ = multibox_loss(
                cfg, preds, tensors, mask_pri, miou_pri,
                maskiou_net=model.maskiou_net, conf_state=state.conf_state,
                num_gts=batch['num_gts'], mesh=mesh)
            state.conf_state = losses.pop('_conf_state', state.conf_state)
            total = sum(losses.values())
            total.backward()
        finally:
            torch.Tensor.float = real_float
        out = dict({k: v.detach() for k, v in losses.items()},
                   total=total.detach())
        if mesh is not None:
            mesh.all_sum_grads(params)
            out = dict(zip(out, mesh.all_sum(
                torch.stack(list(out.values()))).unbind()))
        out = apply_gradients(state, out)
        steps.append(dict({k: float(v) for k, v in out.items()
                           if k not in ('finite', 'lr')},
                          finite=out['finite'], lr=out['lr']))
        if grads is None:
            grads = _numpy({k: p.grad for k, p in model.named_parameters()
                            if p.grad is not None})
        weights.append(_numpy(model.state_dict()))
    conf = None if state.conf_state is None else _numpy(state.conf_state)
    losses = {k: v for k, v in steps[0].items()
              if k not in ('finite', 'lr', 'total')}
    return dict(steps=steps, grads=grads, weights=weights, conf_state=conf,
                losses=losses)


def float64_grads(mesh, cfg, state_dict, batch, seed=0):
    """The first step's gradients and losses in float64
    (:func:`float64_steps` on one batch): the witness of whether two
    float32 runs differ by rounding alone."""
    return float64_steps(mesh, cfg, state_dict, [batch], seed)


def case_run(mesh, cfg, state_dict, batches):
    """:func:`train_steps` on `batches` (float32), and :func:`float64_steps`
    on the first two."""
    return dict(train=train_steps(mesh, cfg, state_dict, batches),
                f64=float64_steps(mesh, cfg, state_dict, batches[:2]))
