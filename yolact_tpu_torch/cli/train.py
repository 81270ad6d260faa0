"""Training CLI of the port: the flags of ``yolact_tpu/cli/train.py`` (the
reference's ``train.py:31-106``).

python -m yolact_tpu_torch.cli.train --config=yolact_base_config --batch_size=8

The loop is the JAX trainer's: the same config overrides (batch-size
autoscaling, ``freeze_bn`` below 6 images per device, ``--stem_s2d``,
``--train_remat``, ``--compute_dtype``, ``--max_gt``), delayed settings, a
loss line and a ``Log`` entry every 10 iterations, saves every
``--save_interval`` iterations named ``<config>_<epoch>_<iter>.pth`` with
``--keep_latest`` pruning, an ``_interrupt`` checkpoint on SIGINT,
``--resume`` from a path, ``interrupt`` or ``latest`` (a port checkpoint or
a JAX ``.ckpt`` with its momentum; a reference ``.pth`` as weights with a
fresh optimizer), and the validation mAP every ``--validation_epoch``
epochs and after the last iteration, through ``eval/evaluate.py`` on the
training model's weights.  A fresh run loads the backbone from
``<save_folder>/<cfg.backbone.path>`` where it exists, then applies the
focal-loss bias init.

It runs on ``cuda:0`` (``--cuda=False``: on the CPU, with the kernels'
plain versions); a CUDA request without a card raises.  The loader hands
the card pinned batches, with the masks bit-packed as JAX's loader ships
them (``data/loader.py``): the full-resolution masks, or for lincomb
configs that binarize the downsampled gt the pre-downsampled ``multires``
targets.  ``--device_augment`` moves the augmentation onto the card, as
JAX's ``use_device_augment``: the loader only resizes (``RawResize``) and
ships uint8 images with full-resolution packed masks, and the step
augments (``data/device_augment.py``) with draws from the trainer's
generator.  ``--batch_alloc`` is accepted and ignored, as in JAX.
``--spatial_split`` > 1 raises with its reason (``parallel/mesh.py``).

``--distributed`` trains data parallel, one process per device, started
by torchrun (``torchrun --nproc_per_node=N -m yolact_tpu_torch.cli.train
--distributed ...``): the process group comes from torchrun's environment
(``parallel/mesh.py:init_from_env``): NCCL on ``cuda:LOCAL_RANK``, gloo
on the CPU with ``--cuda=False``.  Each step is the one-device step on
the global batch (``train/step.py``).
``--batch_size`` is the GLOBAL batch and must divide by the world size
(JAX trims its mesh to a device count that divides it instead);
``freeze_bn`` follows the batch per rank, as JAX's per-data-shard rule,
and autoscaling the global batch.  Every rank shuffles with the same seed
and loads and augments only its rows of each batch; under
``--device_augment`` every rank draws the global batch's augment draws
from its identically seeded generator and keeps its rows
(``train/step.py:train_step``).  Rank 0 alone logs,
saves and runs the validation while the others wait at a barrier; every
rank reads ``--resume``.

:func:`train` also takes in-memory datasets (``dataset``, ``val_dataset``:
objects with ``__len__`` and ``pull_item`` in the ``COCODetection`` item
contract), for machines that cannot read image files, and returns a
summary of the run (see its docstring).
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import threading
import time

import torch

from yolact_tpu_torch.parallel import mesh as parallel


def str2bool(v):
    if isinstance(v, bool):
        return v
    return v.lower() in ('yes', 'true', 't', '1')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='YOLACT training (PyTorch port)')
    p.add_argument('--batch_size', default=8, type=int)
    p.add_argument('--resume', default=None, type=str,
                   help='checkpoint path, "interrupt", or "latest"')
    p.add_argument('--start_iter', default=-1, type=int)
    p.add_argument('--num_workers', default=4, type=int)
    p.add_argument('--lr', '--learning_rate', default=None, type=float)
    p.add_argument('--momentum', default=None, type=float)
    p.add_argument('--decay', '--weight_decay', default=None, type=float)
    p.add_argument('--gamma', default=None, type=float)
    p.add_argument('--save_folder', default='weights/', type=str)
    p.add_argument('--log_folder', default='logs/', type=str)
    p.add_argument('--config', default=None, type=str)
    p.add_argument('--save_interval', default=10000, type=int)
    p.add_argument('--validation_size', default=5000, type=int)
    p.add_argument('--validation_epoch', default=2, type=int)
    p.add_argument('--keep_latest', dest='keep_latest', action='store_true')
    p.add_argument('--keep_latest_interval', default=100000, type=int)
    p.add_argument('--dataset', default=None, type=str)
    p.add_argument('--no_log', dest='log', action='store_false')
    p.add_argument('--log_gpu', dest='log_gpu', action='store_true')
    p.add_argument('--no_interrupt', dest='interrupt', action='store_false')
    p.add_argument('--cuda', default=True, type=str2bool,
                   help='train on cuda:0 (False: on the CPU)')
    p.add_argument('--batch_alloc', default=None, type=str,
                   help='accepted for CLI parity; one device takes the '
                        'whole batch')
    p.add_argument('--no_autoscale', dest='autoscale', action='store_false',
                   help='disable lr/iter scaling by batch_size/8 '
                        '(train.py:91-98)')
    p.add_argument('--max_gt', default=100, type=int,
                   help='fixed ground-truth padding per image')
    p.add_argument('--compute_dtype', default='float32', type=str,
                   help='convolution dtype over float32 master weights')
    p.add_argument('--device_augment', dest='device_augment',
                   action='store_true',
                   help='augment on the device (the loader only resizes '
                        'and ships uint8 images and packed masks)')
    p.add_argument('--distributed', dest='distributed', action='store_true',
                   help='data parallel over the processes torchrun starts '
                        '(one device each; NCCL, gloo with --cuda=False); '
                        '--batch_size is the global batch')
    p.add_argument('--stem_s2d', dest='stem_s2d', action='store_true',
                   help='space-to-depth stem during training (ResNet '
                        'configs; the same math through the stem kernel)')
    p.add_argument('--train_remat', default=None,
                   choices=('none', 'dcn', 'all'),
                   help='backbone bottleneck checkpointing for the backward '
                        "pass (default: the config's, 'dcn')")
    p.add_argument('--spatial_split', default=1, type=int,
                   help='only 1: splitting the image height over devices '
                        'is not ported (parallel/mesh.py)')
    p.set_defaults(keep_latest=False, log=True, log_gpu=False, interrupt=True,
                   autoscale=True, distributed=False, device_augment=False,
                   stem_s2d=False)
    return p.parse_args(argv)


def make_config(args, world: int = 1):
    """The run's config from the flags, as the JAX trainer derives it, for
    `world` data-parallel ranks."""
    from yolact_tpu_torch.config import get_config, get_dataset
    from yolact_tpu_torch.train.schedule import scale_config_for_batch

    cfg = get_config(args.config or 'yolact_base')
    if args.dataset is not None:
        cfg = cfg.copy(dataset=get_dataset(args.dataset),)
    if args.autoscale and args.batch_size != 8:
        factor = args.batch_size / 8.0
        print(f'Scaling parameters by {factor:.2f} to account for a batch '
              f'size of {args.batch_size}.')
        cfg = scale_config_for_batch(cfg, args.batch_size)
    overrides = {}
    for k in ('lr', 'momentum', 'decay', 'gamma'):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    if args.compute_dtype != 'float32':
        overrides['compute_dtype'] = args.compute_dtype
    # freeze BN when the batch per rank is < 6 (train.py:115-118), as JAX's
    # per-data-shard rule
    if args.batch_size // world < 6:
        print('Per-device batch size is less than 6, auto-enabling '
              'freeze_bn.')
        overrides['freeze_bn'] = True
    if args.device_augment:
        overrides['use_device_augment'] = True
    if args.stem_s2d:
        overrides['stem_s2d'] = True
    if args.train_remat is not None:
        overrides['train_remat'] = args.train_remat
    return cfg.copy(**overrides) if overrides else cfg


def _init_fresh(cfg, state, save_folder):
    """init_weights (yolact.py:492-547, train.py:211-213): the pretrained
    backbone where its file exists, then the focal conf-bias; the other
    convs keep the xavier init of ``create_train_state``."""
    from yolact_tpu_torch.convert.backbone_import import (
        focal_bias_init, load_backbone_weights, merge_backbone)
    sd = state.model.state_dict()
    bb_path = os.path.join(save_folder, cfg.backbone.path)
    if os.path.exists(bb_path):
        print(f'Initializing weights from {bb_path}...')
        sd = merge_backbone(sd, load_backbone_weights(cfg, bb_path), cfg)
    else:
        print(f'Backbone weights {bb_path} not found; training the '
              'backbone from random init (the reference errors here — '
              'kept runnable for from-scratch/synthetic workflows).')
    state.model.load_state_dict(focal_bias_init(cfg, sd), strict=True)


def _resume(cfg, state, path):
    """Load `path` into `state`: a train state with its momentum and step,
    or weights with the fresh optimizer (a reference ``.pth``)."""
    from yolact_tpu_torch.train import checkpoint as ckpt
    saved = ckpt.read_checkpoint(cfg, path)
    if 'step' in saved:
        ckpt.restore_checkpoint(state, saved)
        return
    missing, unexpected = state.model.load_state_dict(saved['model'],
                                                      strict=False)
    if unexpected:
        raise RuntimeError(f'{path}: weights the model lacks: '
                           f'{unexpected[:5]}')
    if missing:
        print(f'({len(missing)} weights not in {path} keep their fresh '
              f'init, e.g. {missing[:3]})')


def train(argv=None, dataset=None, val_dataset=None):
    """Run the trainer with the CLI flags `argv`.  `dataset` and
    `val_dataset` stand in for the config's COCO files (``pull_item`` in the
    ``COCODetection`` contract; the training one applies its own
    augmentation).  Returns a summary: the final ``state``, ``epoch`` and
    ``iteration``, the ``start_iter``, the last checkpoint ``path``, the
    ``log`` file (or None), the per-iteration wall seconds ``iter_seconds``
    and the seconds of each spent in the loader ``wait_seconds``, the
    printed ``losses`` entries and the validation ``maps``."""
    args = parse_args(argv)
    mesh, own_group = _start_mesh(args)
    try:
        return _train(args, mesh, dataset, val_dataset)
    finally:
        if own_group:
            parallel.destroy()


def _start_mesh(args):
    """The run's Mesh and whether this call started a process group: one
    rank on the flags' device, or (--distributed) the group torchrun's
    environment describes."""
    from yolact_tpu_torch.infer import check_device
    from yolact_tpu_torch.parallel.mesh import (Mesh, init_from_env,
                                                make_mesh_2d)
    if not args.distributed:
        device = check_device('cuda:0' if args.cuda else 'cpu')
        return make_mesh_2d(Mesh(0, 1, device), args.spatial_split), False
    mesh = init_from_env('nccl' if args.cuda else 'gloo')
    try:
        make_mesh_2d(mesh, args.spatial_split)
        if args.batch_size % mesh.size:
            raise ValueError(
                f'--batch_size {args.batch_size} (the global batch) does not '
                f'divide over {mesh.size} ranks; the JAX trainer trims its '
                f'mesh to a device count that divides the batch, the port '
                f'asks for a batch that divides')
    except BaseException:
        parallel.destroy()
        raise
    return mesh, True


def _train(args, mesh, dataset, val_dataset):
    from yolact_tpu_torch.config import MaskType
    from yolact_tpu_torch.data.augmentations import (RawResize,
                                                     SSDAugmentation)
    from yolact_tpu_torch.data.coco import COCODetection
    from yolact_tpu_torch.data.loader import BatchLoader
    from yolact_tpu_torch.train import checkpoint as ckpt
    from yolact_tpu_torch.train.schedule import apply_delayed_settings
    from yolact_tpu_torch.train.step import create_train_state, train_step
    from yolact_tpu_torch.utils.functions import MovingAverage, SavePath
    from yolact_tpu_torch.utils.logger import Log

    cfg = make_config(args, mesh.size)
    device = mesh.device
    lead = mesh.rank == 0       # logs, saves and validates
    if dataset is None:
        transform = RawResize(cfg) if cfg.use_device_augment else \
            SSDAugmentation(cfg)
        dataset = COCODetection(
            cfg.dataset.train_images, cfg.dataset.train_info,
            transform=transform, dataset_cfg=cfg.dataset)
    # host-augment lincomb configs ship pre-downsampled gt mask targets
    # (reference-exact soft-downsample-then-binarize); device augment
    # computes its own on the card, DIRECT needs full-resolution masks
    multires = None
    if (cfg.mask_type == MaskType.LINCOMB
            and cfg.mask_proto_binarize_downsampled_gt
            and not cfg.use_device_augment):
        from yolact_tpu_torch.ops.anchors import proto_size, seg_size
        multires = {'proto': proto_size(cfg),
                    'seg': seg_size(cfg)
                    if cfg.use_semantic_segmentation_loss else None}
    loader = BatchLoader(dataset, args.batch_size, max_gt=args.max_gt,
                         num_workers=args.num_workers, multires=multires,
                         pack_images=cfg.use_device_augment,
                         pin_memory=device.type == 'cuda',
                         rank=mesh.rank, world=mesh.size)

    state = create_train_state(cfg, device=device, mesh=mesh)
    start_iter = max(args.start_iter, 0)
    if args.resume is not None:
        path = ckpt.resolve_resume(args.resume, args.save_folder, cfg.name)
        if path is None:
            raise FileNotFoundError(f'no checkpoint for --resume={args.resume}')
        print(f'Resuming training from {path}...')
        _resume(cfg, state, path)
        if args.start_iter == -1:
            try:
                start_iter = ckpt.iteration_from_path(path)
            except Exception:
                start_iter = int(state.step)
    else:
        _init_fresh(cfg, state, args.save_folder)
    state.step = start_iter

    log = Log(cfg.name, args.log_folder,
              dict(args=vars(args), config_name=cfg.name),
              overwrite=(args.resume is None),  # reference train.py:193
              log_gpu_stats=args.log_gpu) if args.log and lead else None

    epoch_size = len(dataset) // args.batch_size
    num_epochs = math.ceil(cfg.max_iter / epoch_size)
    loss_avgs = {}
    generator = torch.Generator(device=device).manual_seed(42)
    iteration = start_iter
    last_time = time.time()
    time_avg = MovingAverage()
    summary = dict(start_iter=start_iter, path=None, iter_seconds=[],
                   wait_seconds=[], losses=[], maps=None,
                   log=None if log is None else log.path)

    interrupted = {'flag': False}

    def on_sigint(sig, frame):
        interrupted['flag'] = True

    def stop_now():
        # every rank stops at the same iteration if any was interrupted
        return not mesh.all_true(not interrupted['flag'])

    previous_handler = None
    if args.interrupt and threading.current_thread() is threading.main_thread():
        previous_handler = signal.signal(signal.SIGINT, on_sigint)

    say = print if lead else (lambda *a, **k: None)
    say('Begin training!\n')
    epoch = 0
    try:
        for epoch in range(num_epochs):
            if (epoch + 1) * epoch_size < iteration:
                continue
            for _ in range(epoch_size):
                if iteration == (epoch + 1) * epoch_size:
                    break
                if iteration >= cfg.max_iter or stop_now():
                    break
                new_cfg = apply_delayed_settings(cfg, iteration)
                if new_cfg is not cfg:
                    say(f'(delayed settings applied at iter {iteration})')
                    cfg = state.cfg = state.model.cfg = new_cfg

                with torch.profiler.record_function('train_iteration'):
                    wait = time.time()
                    batch = loader.next_batch()
                    summary['wait_seconds'].append(time.time() - wait)
                    losses = train_step(state, batch, generator)

                iteration += 1
                cur_time = time.time()
                elapsed = cur_time - last_time
                time_avg.add(elapsed)
                summary['iter_seconds'].append(elapsed)
                last_time = cur_time

                if iteration % 10 == 0:
                    losses_np = {k: float(v) for k, v in losses.items()
                                 if k != 'finite'}
                    letters = [k for k in losses_np if k not in ('total', 'lr')]
                    for k in letters:
                        # sampled every 10th iter, so a 10-deep window
                        # spans the reference's 100-iteration average
                        loss_avgs.setdefault(k, MovingAverage(10)).add(
                            losses_np[k])
                    eta = (cfg.max_iter - iteration) * time_avg.get_avg()
                    eta_str = str(int(eta // 3600)) + ':' + \
                        f'{int(eta % 3600 // 60):02d}:{int(eta % 60):02d}'
                    parts = ' | '.join(
                        f'{k}: {loss_avgs[k].get_avg():.3f}' for k in letters)
                    total = sum(loss_avgs[k].get_avg() for k in letters)
                    say(f'[{epoch:3d}] {iteration:7d} || {parts} | '
                        f'T: {total:.3f} || ETA: {eta_str} || '
                        f'timer: {time_avg.get_avg():.3f}')
                    entry = dict(loss={k: losses_np.get(k) for k in letters},
                                 lr=losses_np.get('lr'), epoch=epoch,
                                 iter=iteration, elapsed=elapsed)
                    summary['losses'].append(entry)
                    if log is not None:
                        log.log('train', **entry)

                if iteration % args.save_interval == 0 and iteration > 0:
                    if lead:
                        latest = SavePath.get_latest(
                            args.save_folder, cfg.name) \
                            if args.keep_latest else None
                        path = SavePath(cfg.name, epoch, iteration,
                                        ext='.pth').get_path(
                                            root=args.save_folder)
                        print(f'Saving state, iter: {iteration}')
                        ckpt.save_checkpoint(state, path)
                        summary['path'] = path
                        if args.keep_latest:
                            ckpt.prune_previous_checkpoint(
                                latest, iteration, args.save_interval,
                                args.keep_latest_interval)
                    mesh.barrier()

            if iteration >= cfg.max_iter or stop_now():
                break

            if args.validation_epoch > 0 and epoch % args.validation_epoch \
                    == 0 and epoch > 0:
                if lead:
                    summary['maps'] = compute_validation_map(
                        cfg, state, args, log, epoch, iteration, val_dataset)
                mesh.barrier()
    finally:
        loader.stop()
        if previous_handler is not None:
            signal.signal(signal.SIGINT, previous_handler)

    summary.update(state=state, epoch=epoch, iteration=iteration)
    if stop_now():
        if lead:
            print('Stopping early. Saving network...')
            SavePath.remove_interrupt(args.save_folder)
            path = SavePath(cfg.name, epoch, f'{iteration}_interrupt',
                            ext='.pth').get_path(root=args.save_folder)
            ckpt.save_checkpoint(state, path)
            summary['path'] = path
        mesh.barrier()
        return summary

    if lead:
        path = SavePath(cfg.name, epoch, iteration, ext='.pth').get_path(
            root=args.save_folder)
        ckpt.save_checkpoint(state, path)
        summary['path'] = path
        # validation mAP on the final weights (reference train.py:384-385
        # computes it after the training loop)
        if args.validation_epoch > 0:
            summary['maps'] = compute_validation_map(
                cfg, state, args, log, epoch, iteration, val_dataset)
    mesh.barrier()
    return summary


def compute_validation_map(cfg, state, args, log, epoch, iteration,
                           val_dataset=None):
    """Per-epoch val mAP (train.py:369-374,485-498) of the training model's
    weights, maskiou head included; the dataset is `val_dataset` or the
    config's validation set.  Returns the all_maps dict, or None when there
    is no validation set."""
    from yolact_tpu_torch.eval.evaluate import (evaluate_dataset,
                                                make_eval_dataset)
    if val_dataset is None:
        try:
            val_dataset = make_eval_dataset(cfg)
        except FileNotFoundError:
            print('(validation dataset unavailable; skipping val mAP)')
            return None
    weights = {k: v.detach() for k, v in state.model.state_dict().items()}
    start = time.time()
    maps = evaluate_dataset(cfg, weights, val_dataset, device=state.device,
                            max_images=args.validation_size, quiet=False)
    if log is not None and maps is not None:
        log.log('val', box=maps['box'], mask=maps['mask'], epoch=epoch,
                iter=iteration, elapsed=time.time() - start)
    return maps


if __name__ == '__main__':
    train()
