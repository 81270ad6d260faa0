"""Training: the trainer's iteration, ``BatchLoader.next_batch`` then
``train_step``, as ``cli/train.py --device_augment`` runs it.

The mix (``traffic/<mix>.json``) gives ``batch`` images a step from a
set of ``frames`` seeded raw BGR uint8 frames of ``frame_hws`` (in turn),
each with 1-3 objects and one crowd (rectangular or elliptic masks inside
their boxes, random foreground classes), loaded by ``workers`` loader
threads through the port's ``RawResize`` with packed masks and uint8
images in pinned memory, augmented on the card.  The config is scaled
for the batch as the trainer's ``--autoscale`` does.  Set-up builds one
train state and drives it through ``checked_steps`` steps through the
window's own feed and call (rows that all differ: the first epoch's
batches) and ``warmup_steps`` more, which warm every shape up; the window
goes on with the same state.  Each step is timed by the host clock from the loader's call to
the end of a synchronize after the step; the loader's wait is timed
apart.  A step whose loss or gradients are not finite is skipped by the
program and counts as failed.

``correct``: once the window has closed, the reference (a float32 copy
of the model, the loss, the matcher and the augmentation, and
``torch.optim.SGD``) follows the first ``checked_steps`` steps from the
same weights, frames and draws; each step's total loss, each leaf's
first gradient as the optimizer got it (the momentum after step 1, less
the weight decay of the initial weights) and each leaf's change after
the checked steps are compared by the gap of their norms, over the
reference's norm of the leaf or the median leaf's, whichever is larger,
the worst leaf taken; leaves whose reference gradient is under a
thousandth of the median leaf's are left out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark import trace, weights, yardstick

GRAD_FLOOR = 1e-3


@dataclasses.dataclass
class State:
    cell: Any
    seed: int
    dev: torch.device
    cfg: Any
    ref_cfg: Any
    state_dict: Dict[str, torch.Tensor]
    frames: List[tuple]
    loader: Any
    train: Any
    generator: torch.Generator
    first: Dict[str, Any]


def sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def configs(cell) -> tuple:
    """(the port's config, the reference's): the named config with the
    file's compute dtype, device augmentation and overrides, scaled for
    the batch as the trainer's --autoscale does; both checked against the
    numbers the configuration file states."""
    from yolact_tpu_torch.config import get_config as port_config
    from yolact_tpu_torch.train.schedule import scale_config_for_batch

    from benchmark.reference.config import get_config as ref_config
    from benchmark.reference.train.schedule import \
        scale_config_for_batch as ref_scale
    spec, batch = cell.config, cell.traffic['batch']
    over = dict(spec.get('overrides', {}), use_device_augment=True,
                compute_dtype=spec['compute_dtype'],
                **cell.traffic.get('config', {}))
    if batch < 6:
        over['freeze_bn'] = True
    cfg = port_config(spec['port_config']).copy(**over)
    ref = ref_config(spec['port_config']).copy(**dict(over, stem_s2d=False))
    if batch != 8:
        cfg = scale_config_for_batch(cfg, batch)
        ref = ref_scale(ref, batch)
    for key, want in spec['config'].items():
        for side, c in (('port', cfg), ('reference', ref)):
            got = getattr(c, key)
            got = list(got) if isinstance(got, tuple) else got
            if got != want:
                raise ValueError(f'{cell.config_name}: the {side} config '
                                 f'has {key}={got!r}, the file {want!r}')
    return cfg, ref


def make_frames(traffic, seed: int, num_classes: int) -> List[tuple]:
    """(raw BGR uint8 image [H, W, 3], relative boxes [k, 4], masks
    [k, H, W] uint8, labels [k] float with the crowd last at -1)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(traffic['frames']):
        h, w = traffic['frame_hws'][i % len(traffic['frame_hws'])]
        k = int(rng.integers(1, 4)) + 1
        xy1 = rng.random((k, 2)) * 0.6
        xy2 = np.minimum(xy1 + 0.15 + rng.random((k, 2)) * 0.3, 1.0)
        boxes = np.hstack([xy1, xy2])
        yy, xx = np.mgrid[:h, :w] + 0.5
        masks = np.zeros((k, h, w), np.uint8)
        for j, (x1, y1, x2, y2) in enumerate(boxes * [w, h, w, h]):
            if j % 2:
                cx, cy, rx, ry = ((x1 + x2) / 2, (y1 + y2) / 2,
                                  (x2 - x1) / 2, (y2 - y1) / 2)
                masks[j] = (((xx - cx) / rx) ** 2
                            + ((yy - cy) / ry) ** 2) <= 1
            else:
                masks[j, int(y1):int(y2), int(x1):int(x2)] = 1
        labels = np.append(rng.integers(0, num_classes - 1, k - 1),
                           -1).astype(np.float64)
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out.append((image, boxes, masks, labels))
    return out


class FrameSet:
    """The frames in the loader's dataset contract (``data/coco.py:
    COCODetection.pull_item``) after the port's transform."""

    def __init__(self, frames, transform):
        self.frames = frames
        self.transform = transform

    def __len__(self):
        return len(self.frames)

    def pull_item(self, index):
        frame, boxes, masks, labels = self.frames[index]
        h, w = frame.shape[:2]
        img, masks, boxes, out = self.transform(
            frame, masks.astype(np.float32), boxes.copy(),
            {'num_crowds': 1, 'labels': labels})
        target = np.hstack([boxes, out['labels'][:, None]]).astype(np.float32)
        return img, target, masks, h, w, out['num_crowds']


def loader_order(n: int, seed: int) -> np.ndarray:
    """The frames of the loader's first epoch, in order (``BatchLoader``
    shuffles with ``RandomState(seed)``)."""
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    return order


def loader_seed(seed: int) -> int:
    return seed % 2 ** 32


def make_weights(ref_cfg, spec, gen, dev) -> Dict[str, torch.Tensor]:
    from benchmark.reference.models.resnet import DCNLayer
    model = yardstick.reference_model(ref_cfg, device=dev)
    sd = weights.init_state_dict(model, gen, DCNLayer, dev)
    del model
    return weights.shape(sd, spec.get('train_weights', {}),
                         ref_cfg.num_classes, gen)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def setup(cell, seed: int, run, device: Optional[str] = None) -> State:
    from yolact_tpu_torch.data.augmentations import RawResize
    from yolact_tpu_torch.data.loader import BatchLoader
    from yolact_tpu_torch.train.step import create_train_state, train_step

    dev = torch.device(device or 'cuda:0')
    traffic = cell.traffic
    cfg, ref_cfg = configs(cell)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = make_weights(ref_cfg, cell.config, gen, dev)
    frames = make_frames(traffic, seed, cfg.num_classes)
    loader = BatchLoader(FrameSet(frames, RawResize(cfg)), traffic['batch'],
                         max_gt=traffic['max_gt'],
                         num_workers=traffic['workers'], pack_images=True,
                         pin_memory=dev.type == 'cuda',
                         seed=loader_seed(seed))
    state = create_train_state(cfg, device=dev, state_dict=sd)
    step_gen = torch.Generator(device=dev).manual_seed(seed)
    opt = state.optimizer
    params = {n: p for n, p in state.model.named_parameters()
              if p.requires_grad}
    p0 = {n: p.detach().clone() for n, p in params.items()}
    first = {'losses': [], 'finite': []}
    for i in range(traffic['checked_steps']):
        out = train_step(state, loader.next_batch(), step_gen)
        first['losses'].append(float(out['total']))
        first['finite'].append(bool(out['finite']))
        if i == 0:
            first['grad'] = leaf_norms({
                n: opt.state[p]['momentum_buffer'] - cfg.decay * p0[n]
                for n, p in params.items() if p in opt.state})
    first['change'] = leaf_norms({n: p.detach() - p0[n]
                                  for n, p in params.items()})
    del p0
    # the pinned host blocks, the allocator's pools and the matcher's and
    # loss's shapes settle over the first steps: a few more before the
    # window (3 checked steps alone left 1-3 s steps at its start)
    for _ in range(traffic['warmup_steps']):
        train_step(state, loader.next_batch(), step_gen)
    sync(dev)
    run.items_per_call = traffic['batch']
    run.flops_per_item = 3 * cell.config['flops_per_image']
    return State(cell, seed, dev, cfg, ref_cfg, sd, frames, loader, state,
                 step_gen, first)


def _step(state: State, run=None):
    from yolact_tpu_torch.train.step import train_step
    t0 = time.perf_counter()
    batch = state.loader.next_batch()
    t1 = time.perf_counter()
    out = train_step(state.train, batch, state.generator)
    sync(state.dev)
    t2 = time.perf_counter()
    if run is not None:
        run.calls.append((t0, t2))
        run.waits.append(t1 - t0)
        if not out['finite']:
            run.failed += run.items_per_call
    return out


def window(state: State, run) -> None:
    if state.dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(state.dev)
    end = time.perf_counter() + run.seconds
    while not run.calls or time.perf_counter() < end:
        _step(state, run)
    if state.dev.type == 'cuda':
        run.window_peak_bytes = torch.cuda.max_memory_allocated(state.dev)


def kernel_launches() -> Dict[str, Any]:
    from yolact_tpu_torch.kernels import dcn, stem
    return {'stem_s2d_mma_kernel': lambda: stem.launches,
            'dcn_im2col_kernel': lambda: dcn.launches,
            'dcn_col2im_kernel': lambda: dcn.col2im_launches}


def traced_slice(state: State, run) -> None:
    launches = kernel_launches()
    before = {k: v() for k, v in launches.items()}
    made = [0]

    def step():
        _step(state)
        made[0] += 1
    run.device_trace = trace.profile(step, state.cell.traffic['trace_steps'])
    run.kernel_launches = {k: (v() - before[k]) // made[0]
                           for k, v in launches.items()}
    run.kernel_bounds = yardstick.train_kernel_bounds(
        state.ref_cfg, state.cell.traffic['batch'],
        state.cell.config['compute_dtype'], state.cfg.stem_s2d,
        state.cfg.train_remat)


def free_program(state: State) -> None:
    """Stop the loader and wait for its threads (the port's ``stop``
    only signals them), then free the train state."""
    state.loader.stop()
    for thread in state.loader._threads:
        thread.join(timeout=10.0)
    state.train = None
    gc.collect()
    if state.dev.type == 'cuda':
        torch.cuda.empty_cache()


def reference_batches(state: State) -> List[Dict[str, np.ndarray]]:
    from benchmark.reference.data.batch import raw_batch
    traffic = state.cell.traffic
    b = traffic['batch']
    order = loader_order(len(state.frames), loader_seed(state.seed))
    return [raw_batch([state.frames[j] for j in order[i * b:(i + 1) * b]],
                      state.ref_cfg, traffic['max_gt'])
            for i in range(traffic['checked_steps'])]


def reference_run(state: State, precision: str = 'float32'):
    """The reference's checked steps from the state's weights: (total loss
    a step, first-gradient norms, change norms, the finite flags)."""
    from benchmark.reference.precision import fp8_operands
    from benchmark.reference.train.step import create_state, train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = 'float32' if precision == 'float32' else 'bfloat16'
    ref = create_state(state.ref_cfg, state.state_dict, state.dev, dtype)
    gen = torch.Generator(device=state.dev).manual_seed(state.seed)
    p0 = {n: p.detach().clone() for n, p in ref.model.named_parameters()
          if p.requires_grad}
    losses, finite, grads = [], [], None
    for i, batch in enumerate(reference_batches(state)):
        if precision == 'fp8':
            with fp8_operands():
                out, ok, kept = train_step(ref, batch, gen, i == 0)
        else:
            out, ok, kept = train_step(ref, batch, gen, i == 0)
        losses.append(out['total'])
        finite.append(ok)
        if kept is not None:
            grads = leaf_norms(kept)
    change = leaf_norms({n: p.detach() - p0[n]
                         for n, p in ref.model.named_parameters()
                         if p.requires_grad})
    return {'losses': losses, 'finite': finite, 'grad': grads,
            'change': change}


def compare(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """The numbers the check can compare: the worst step's relative gap of
    total loss (``loss_gap``) and the first step's (``loss_gap_first``);
    for the first gradient and for the change after the checked steps,
    the gap of each leaf's norm over the reference's norm of the leaf or
    the median leaf's, whichever is larger, by the worst leaf
    (``grad_norm_gap``, ``change_norm_gap``) and the median leaf
    (``_p50``), on the leaves whose reference gradient is at least
    GRAD_FLOOR of the median leaf's; the five worst leaves of each by
    name, for the look."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog['losses'],
                                                ref['losses'])]
    med = float(np.median(list(ref['grad'].values())))
    leaves = [k for k, v in ref['grad'].items() if v >= GRAD_FLOOR * med]
    out = {'loss_gap': max(gaps), 'loss_gap_first': gaps[0],
           'skipped_steps': float(sum(not f for f in prog['finite']))}
    for key in ('grad', 'change'):
        r = ref[key]
        scale = max(float(np.median([r[k] for k in leaves])), 1e-30)
        by_leaf = {k: abs(prog[key].get(k, 0.0) - r[k]) / max(r[k], scale)
                   for k in leaves}
        out[f'{key}_norm_gap'] = max(by_leaf.values())
        out[f'{key}_norm_gap_p50'] = float(np.median(list(by_leaf.values())))
        out[f'worst_{key}_leaves'] = sorted(
            by_leaf.items(), key=lambda kv: -kv[1])[:5]
    return out


def check(state: State, run):
    free_program(state)
    numbers = compare(state.first, reference_run(state))
    compared = [(name, numbers.get(name, 1.0), limit)
                for name, limit in state.cell.limits.items()]
    compared.append(('skipped_steps', numbers['skipped_steps'], 0))
    ok = all(v <= limit for _, v, limit in compared)
    return ok, compared


# the faults read on the card; a step that leaves the state unchanged
# reads 1 on change_norm_gap by the measure itself
FAULTS = ('half_batch', 'loss_letter_dropped')


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """A fault planted under the program's train step: ``half_batch``
    leaves out the second half of every batch (the loss is the mean over
    the rest); ``loss_letter_dropped`` leaves the semantic segmentation
    letter (S) out of the loss where the loss is produced; ``unchanged``
    returns the state as it was (the step counted, nothing applied)."""
    import yolact_tpu_torch.train.step as step
    original = step.loss_and_grads
    apply = step.apply_gradients

    def unchanged(state, losses):
        from yolact_tpu_torch.models.layers import drop_batch_stats
        drop_batch_stats(state.model)
        state.step += 1
        return dict(losses, lr=0.0, finite=True)

    def half(state, batch, mask_priorities, maskiou_priorities,
             use_kernels=True, augment_draws=None):
        n = batch['image'].shape[0] // 2
        batch = {k: v[:n] if getattr(v, 'ndim', 0) else v
                 for k, v in batch.items()}
        draws = {k: v[:n] for k, v in augment_draws.items()}
        return original(state, batch, mask_priorities[:n],
                        maskiou_priorities, use_kernels, draws)

    forward = step.forward_loss

    def letter_dropped(*a, **k):
        losses = forward(*a, **k)
        losses.pop('S', None)
        return dict(losses, total=sum(v for n, v in losses.items()
                                      if n != 'total'))

    if fault == 'unchanged':
        step.apply_gradients = unchanged
    elif fault == 'half_batch':
        step.loss_and_grads = half
    elif fault == 'loss_letter_dropped':
        step.forward_loss = letter_dropped
    elif fault is not None:
        raise ValueError(f'unknown fault {fault!r}')
    try:
        yield
    finally:
        step.loss_and_grads = original
        step.apply_gradients = apply
        step.forward_loss = forward


def calibrate(cell, seed: int, control: bool, faults=FAULTS):
    """The readings a limit is set from, for the calibration tool
    (``calibrate.py``): [(side, numbers)] for the program's checked steps
    on this seed against the reference and, with `control`, the reference
    at fp8 operands in the program's place (the control), at bfloat16 (the
    program's own precision), and the program with each fault planted."""
    from benchmark.record import Run

    def program(fault=None):
        run = Run(cell=cell.name, mode=cell.mode, seed=seed, seconds=0,
                  trace=False, t0=time.perf_counter())
        with planted(fault):
            state = setup(cell, seed, run)
        free_program(state)
        return state

    state = program()
    ref = reference_run(state)
    out = [('program', compare(state.first, ref))]
    if control:
        for side, precision in (('control_fp8', 'fp8'),
                                ('reference_bf16', 'bfloat16')):
            out.append((side, compare(reference_run(state, precision), ref)))
        for fault in faults:
            out.append((f'fault_{fault}', compare(program(fault).first, ref)))
    return out
