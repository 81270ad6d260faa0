#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 12 (spatial partitioning) alone, or its
phase 12b (the other configs).

    python3 probe_spatial.py [--memory | --configs [NAME ...] [--cudnn]]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds the kernels, makes the smoke script's seeded weights of
yolact_plus_base and its raw frames, runs the one-process b8 step that
phase 10 would have run (``chip_smoke.one_process_steps``), then
``chip_smoke.spatial_phase``: two gloo ranks sharing the card split data
1 x space 2 against that step (losses, first gradients, bit-equal
weights, launches, the control, ms a step, the collectives' share, peak
memory per rank against one process and against one process on the
global batch-norm path), ``Pipeline`` under the mesh against
``Pipeline`` at b1 f32 and b8 bf16, and both DCN kernels from ``row0 >
0``.  It prints what phase 12 prints and exits 1 when a check fails.  It
imports nothing of JAX or of the JAX package.

``--memory`` instead breaks one train step's memory down, in one process,
on each of the two spatial ranks and on each of two data-parallel ranks
of 4 images (phase 10's split; same config, weights, batch and seeds):
the memory allocated before the step (weights, momentum, the batch), what
the forward adds (the activations kept for the backward and the
outputs), what the loss adds, and the peak over the step, in GiB.

``--configs`` runs ``chip_smoke.spatial_configs_phase`` instead: the
configs named (default: all of ``chip_smoke.SPC_CONFIGS``, yolact_darknet53,
yolact_vgg16, yolact_base_gn, yolact_base_direct and yolact_base_options)
from the smoke script's seeded weights, one-process references, then the
two ranks' step, controls and ``Pipeline`` under the mesh; it goes on
past a failed check, prints each, and exits 1 at the end if any failed.
With ``--cudnn`` the checked steps run cuDNN's convolutions instead of
PyTorch's own (what ``chip_smoke.native_convolutions`` avoids: cuDNN's
per-shape algorithms round a rank's row windows otherwise).
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as smoke
from yolact_tpu_torch.infer import random_state_dict
from yolact_tpu_torch.kernels import _build


def step_memory(state, batch, gen):
    """One train step's memory (GiB): before it, added by the forward,
    added by the loss, and its peak.  The step's second call (the first
    leaves the gradients and the momentum in place)."""
    from yolact_tpu_torch.train import step as S
    rec = {}

    def after_forward(module, inputs, outputs):
        rec.setdefault('forward', torch.cuda.memory_allocated())

    hook = state.model.register_forward_hook(after_forward)
    try:
        S.train_step(state, batch, gen)
        rec.clear()
        data = state.mesh.data_mesh if state.mesh is not None else None
        n = batch['image'].shape[0] * (1 if data is None else data.size)
        priors = state.model.priors(batch['image'].shape[1],
                                    batch['image'].shape[2], state.device)
        mask_pri, miou_pri = S.draw_priorities(state.cfg, n, priors.shape[0],
                                               gen, state.device)
        if data is not None:
            mask_pri = mask_pri[data.rows(n)]
        tensors = S.prepare_batch(state.cfg, S.batch_to_device(
            batch, state.device))
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses = S.forward_loss(state, tensors, mask_pri, miou_pri)
        loss = torch.cuda.memory_allocated()
        losses['total'].backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        hook.remove()
    gib = 2 ** 30
    return dict(before=base / gib, forward=(rec['forward'] - base) / gib,
                loss=(loss - rec['forward']) / gib, peak=peak / gib)


def memory_rank(rank, port, sd_path, space, results):
    """One rank of --memory (spawned): step_memory on two ranks split
    data 1 x space 2 (`space` 2) or data 2 (`space` 1: its rows of the
    batch)."""
    import traceback
    from yolact_tpu_torch.parallel import mesh as parallel
    from yolact_tpu_torch.train.step import create_train_state
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(smoke.SP_SPACE),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port))
    try:
        dev = torch.device('cuda', 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.load()
        mesh = parallel.make_mesh_2d(
            parallel.init_from_env('gloo', device=dev), space)
        cfg = smoke.dp_config()
        state = create_train_state(cfg, state_dict=torch.load(sd_path),
                                   mesh=mesh)
        data = mesh.data_mesh
        batch = parallel.shard_batch(smoke.make_train_batch(cfg), data.rank,
                                     data.size)
        results.put((rank, True, step_memory(
            state, batch, torch.Generator(device=dev).manual_seed(11))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        parallel.destroy()


def memory(sd, dev, card):
    """--memory (see the module docstring)."""
    import multiprocessing as mp
    import tempfile
    from yolact_tpu_torch.train.step import create_train_state
    cfg = smoke.dp_config()
    sd = smoke.tame_residuals(sd)
    state = create_train_state(cfg, device=dev, state_dict=sd)
    one = step_memory(state, smoke.make_train_batch(cfg),
                      torch.Generator(device=dev).manual_seed(11))
    del state
    torch.cuda.empty_cache()
    tag = f'memory {smoke.DP_CONFIG} 550 b8 f32 one train step (GiB)'
    print(f'{tag}, one process: {json.dumps(one)} [{card}]')
    with tempfile.TemporaryDirectory(prefix='probe_spatial_') as tmp:
        path = os.path.join(tmp, 'weights.pt')
        torch.save(sd, path)
        for space, grid in ((smoke.SP_SPACE, 'data 1 x space 2'),
                            (1, 'data 2, 4 images a rank')):
            ctx = mp.get_context('spawn')
            results = ctx.Queue()
            port = smoke.free_port()
            procs = [ctx.Process(target=memory_rank,
                                 args=(rank, port, path, space, results))
                     for rank in range(2)]
            for proc in procs:
                proc.start()
            got = {}
            try:
                while len(got) < 2:
                    rank, ok, value = results.get(timeout=smoke.DP_SECONDS)
                    smoke.check(ok, f'memory rank {rank} failed:\n{value}')
                    got[rank] = value
            finally:
                for proc in procs:
                    proc.join(timeout=60)
                    if proc.is_alive():
                        proc.kill()
            for rank in range(2):
                print(f'{tag}, {grid}, rank {rank}: '
                      f'{json.dumps(got[rank])} [{card}]')


def main():
    args = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    args.add_argument('--memory', action='store_true')
    args.add_argument('--configs', nargs='*', default=None,
                      choices=smoke.SPC_CONFIGS)
    args.add_argument('--cudnn', action='store_true')
    args = args.parse_args()
    if not torch.cuda.is_available():
        print('probe_spatial: needs a CUDA device', file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda)
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load()
    print(f'build {time.perf_counter() - t0:.1f} s')
    frames8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (8, 550, 550, 3)).astype(np.float32)).to(dev)
    if args.configs is not None:
        configs = tuple(args.configs) or smoke.SPC_CONFIGS
        sds = {name: random_state_dict(smoke.config_named(name),
                                       torch.Generator().manual_seed(0))
               for name in configs}
        failed = []

        def keep_going(cond, msg):
            if not cond:
                failed.append(msg)
                print(f'FAILED: {msg}', flush=True)
        smoke.check = keep_going
        t0 = time.perf_counter()
        launches = smoke.spatial_configs_phase(
            sds, frames8, dev, card, configs,
            contextlib.nullcontext if args.cudnn
            else smoke.native_convolutions)
        print(f'phase 12b: {time.perf_counter() - t0:.1f} s')
        print(json.dumps({'spatial_config_launches': launches}))
        if failed:
            print(f'{len(failed)} checks failed', file=sys.stderr)
            sys.exit(1)
        return
    config = smoke.DP_CONFIG
    sd = random_state_dict(smoke.config_named(config),
                           torch.Generator().manual_seed(0))
    sds = {config: smoke.seed_offsets_state_dict(
        sd, torch.Generator().manual_seed(3))}
    if args.memory:
        memory(sds[config], dev, card)
        return
    t0 = time.perf_counter()
    launches = smoke.spatial_phase(sds, frames8, dev, card)
    print(f'phase 12: {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'spatial_launches_per_rank_step': launches}))


if __name__ == '__main__':
    main()
