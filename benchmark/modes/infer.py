"""Offline inference: one caller, a closed loop of ``Pipeline`` calls.

The mix (``traffic/<mix>.json``) gives ``batch`` frames a call of
``frame_hw`` [height, width] raw uint8 BGR pixels, drawn on the card from
the seed as a pool of ``pool_frames`` frames and held in host memory, as a
batch job reads them; ``warmup_calls`` calls warm every shape up before
the window, ``trace_calls`` calls are profiled after it, and
``judged_calls`` calls of the window (drawn from the seed among the first
``judge_from`` calls, and the last call) are held against the reference
once the window has closed.  The configuration file
(``configs/<config>.json``) names the port's config, its compute dtype
and the weight shaping.

Each call is timed by the host clock from the call to the end of a
``torch.cuda.synchronize()`` after it: ``Pipeline.__call__`` copies the
frames to the card and ends in detection's own host read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark import judge, trace, weights, yardstick


@dataclasses.dataclass
class State:
    cell: Any
    seed: int
    dev: torch.device
    cfg: Any                 # the port's config, as the Pipeline runs it
    ref_cfg: Any             # the reference's
    state_dict: Dict[str, torch.Tensor]
    batches: List[np.ndarray]
    pipe: Any
    judged: set
    outputs: Dict[int, Any] = dataclasses.field(default_factory=dict)
    calls: int = 0
    # the warm-up's calls: the window's call i takes the pool's batch
    # after the warm-up's last, so that no call repeats the one before
    offset: int = 0

    def batch(self, i: int) -> np.ndarray:
        return self.batches[(i + self.offset) % len(self.batches)]


def sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def configs(cell) -> tuple:
    """(the port's config, the reference's) for the cell, each checked
    against the numbers the configuration file states."""
    from yolact_tpu_torch.config import get_config as port_config

    from benchmark.reference.config import get_config as ref_config
    spec = cell.config
    overrides = spec.get('overrides', {})
    cfg = port_config(spec['port_config']).copy(
        compute_dtype=spec['compute_dtype'], **overrides)
    # the reference runs the plain 7x7/s2 stem
    ref = ref_config(spec['port_config']).copy(**dict(overrides,
                                                      stem_s2d=False))
    for key, want in spec['config'].items():
        for side, c in (('port', cfg), ('reference', ref)):
            got = getattr(c, key)
            got = list(got) if isinstance(got, tuple) else got
            if got != want:
                raise ValueError(f'{cell.config_name}: the {side} config '
                                 f'has {key}={got!r}, the file {want!r}')
    return cfg, ref


def make_weights(ref_cfg, spec, gen, dev, frames: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """The seed's weights, shaped as the configuration file says; the
    background bias is read from the reference's float32 conf logits on
    `frames` (the pool's first batch), so that every seed sends about
    ``candidates_per_image`` priors an image into the NMS."""
    from benchmark.reference.infer import _prepare_input
    from benchmark.reference.models.resnet import DCNLayer
    shaping = spec.get('weights', {})
    model = yardstick.reference_model(ref_cfg, device=dev)
    sd = weights.shape(weights.init_state_dict(model, gen, DCNLayer, dev),
                       shaping, ref_cfg.num_classes, gen)
    if 'candidates_per_image' in shaping:
        model.load_state_dict(sd)
        with torch.no_grad():
            conf = model.eval()(_prepare_input(ref_cfg, frames, True),
                                use_kernels=False)['conf']
        beta = weights.background_bias(
            conf, ref_cfg.nms_conf_thresh, shaping['candidates_per_image'],
            ref_cfg.nms_candidates)
        sd = weights.add_background_bias(sd, beta, ref_cfg.num_classes)
    del model
    return sd


def setup(cell, seed: int, run, device: Optional[str] = None) -> State:
    """Weights and frames from the seed, the program built, every shape of
    the cell warmed up.  `device` (default the first card) exists for the
    tests, which drive a run on the CPU."""
    from yolact_tpu_torch.infer import Pipeline

    dev = torch.device(device or 'cuda:0')
    traffic = cell.traffic
    cfg, ref_cfg = configs(cell)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, w = traffic['frame_hw']
    b = traffic['batch']
    pool = torch.randint(0, 256, (traffic['pool_frames'], h, w, 3),
                         generator=gen, device=dev, dtype=torch.uint8)
    sd = make_weights(ref_cfg, cell.config, gen, dev, pool[:b])
    pool = pool.cpu().numpy()
    batches = [np.ascontiguousarray(pool[i:i + b])
               for i in range(0, len(pool) - b + 1, b)]
    pipe = Pipeline(cfg, sd, dev, compute_dtype=cell.config['compute_dtype'])
    rng = np.random.default_rng(seed)
    judged = set(rng.choice(traffic['judge_from'],
                            traffic['judged_calls'] - 1,
                            replace=False).tolist())
    state = State(cell, seed, dev, pipe.cfg, ref_cfg, sd, batches, pipe,
                  judged)
    for i in range(traffic['warmup_calls']):
        pipe(batches[i % len(batches)])
    state.offset = traffic['warmup_calls']
    sync(dev)
    run.items_per_call = b
    run.flops_per_item = cell.config['flops_per_image']
    return state


def _call(state: State) -> Any:
    out = state.pipe(state.batch(state.calls))
    sync(state.dev)
    return out


def window(state: State, run) -> None:
    """The closed loop for ``run.seconds``: no call starts after the
    window's end, and the window ends with its last call."""
    if state.dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(state.dev)
    start = time.perf_counter()
    end = start + run.seconds
    last = None
    while True:
        t = time.perf_counter()
        if t >= end and run.calls:
            break
        out = _call(state)
        run.calls.append((t, time.perf_counter()))
        if state.calls in state.judged:
            state.outputs[state.calls] = out
        last = (state.calls, out)
        state.calls += 1
    state.outputs[last[0]] = last[1]
    if state.dev.type == 'cuda':
        run.window_peak_bytes = torch.cuda.max_memory_allocated(state.dev)


def traced_slice(state: State, run) -> None:
    """``trace_calls`` calls under the profiler (``trace.profile``: more
    where a pass lost events, and a pass naming the gaps), after the
    window, with the launches of each kernel a call counted by the
    program's counters; then the kernels' bounds at the cell's shapes."""
    launches = kernel_launches()
    before = {k: v() for k, v in launches.items()}
    first = state.calls

    def call():
        _call(state)
        state.calls += 1
    run.device_trace = trace.profile(call, state.cell.traffic['trace_calls'])
    made = state.calls - first
    run.kernel_launches = {k: (v() - before[k]) // made
                           for k, v in launches.items()}
    run.kernel_bounds = yardstick.infer_kernel_bounds(
        state.ref_cfg, state.cell.traffic['batch'],
        state.cell.config['compute_dtype'], state.cfg.stem_s2d)


def kernel_launches() -> Dict[str, Any]:
    """Each hand-written kernel's CUDA symbol -> a reader of the port's
    launch counter for it (``kernels/*.py``)."""
    from yolact_tpu_torch.kernels import dcn, mask_assembly, nms, stem
    return {'fast_nms_iou_max_kernel': lambda: nms.launches,
            'mask_assembly_kernel': lambda: mask_assembly.launches,
            'stem_s2d_mma_kernel': lambda: stem.launches,
            'dcn_im2col_kernel': lambda: dcn.launches}


def reference_model(state: State, precision: str):
    """The reference's model on the state's weights: float32 with TF32
    off, or (the control) bfloat16 with fp8 operands."""
    from benchmark.reference.infer import load_model
    dtype = 'float32' if precision == 'float32' else 'bfloat16'
    model = load_model(state.ref_cfg, state.state_dict, state.dev, dtype)
    return model


def judge_outputs(state: State, outputs: Dict[int, Any], model,
                  fp8: bool = False) -> Dict[str, float]:
    from benchmark.reference.precision import fp8_operands
    gaps, counts = judge.new_readings()
    for i, out in sorted(outputs.items()):
        frames = torch.as_tensor(state.batch(i), device=state.dev)
        if fp8:
            with fp8_operands():
                tables = judge.ReferenceTables(state.ref_cfg, model, frames)
        else:
            tables = judge.ReferenceTables(state.ref_cfg, model, frames)
        judge.judge_batch(out, tables, gaps, counts)
        del tables
    return judge.summary(gaps, counts)


def free_program(state: State) -> None:
    state.pipe = None
    gc.collect()
    if state.dev.type == 'cuda':
        torch.cuda.empty_cache()


def check(state: State, run):
    """The judged calls' outputs against the reference, once the program
    is freed: (correct, [(name, value, limit)]) for the numbers the cell's
    limits name (each must be at most its limit)."""
    free_program(state)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = reference_model(state, 'float32')
    numbers = judge_outputs(state, state.outputs, model)
    state.outputs.clear()
    # a gap with no detection to read reads 1, past any limit
    compared = [(name, numbers.get(name, 1.0), limit)
                for name, limit in state.cell.limits.items()]
    # a run that judged no detection has shown nothing
    compared.append(('no_detections', float(numbers['detections'] == 0), 0))
    ok = all(v <= limit for _, v, limit in compared)
    return ok, compared


def _no_maskiou(out):
    """The mask scorer left out: each mask score is the detection's
    score, as if every mask's IoU were 1."""
    return out._replace(mask_scores=out.scores)


# faults planted in the program's answers of a config with a mask scorer,
# read beside the control
MASKIOU_FAULTS = {'no_maskiou': _no_maskiou}


def calibrate(cell, seed: int, control: bool):
    """The readings a limit is set from, for the calibration tool
    (``calibrate.py``): [(side, numbers)] for the program on this seed
    (its set-up, the judged number of calls through the timed entry) and,
    with `control`, the reference in the program's place at fp8 operands
    (the control) and at bfloat16 (the program's own precision), and, for
    a config with a mask scorer, the program's answers with each fault of
    ``MASKIOU_FAULTS`` planted."""
    from yolact_tpu_torch.detect import detection

    from benchmark.record import Run
    from benchmark.reference.infer import forward_and_detect
    from benchmark.reference.precision import fp8_operands
    run = Run(cell=cell.name, mode=cell.mode, seed=seed, seconds=0,
              trace=False, t0=time.perf_counter())
    state = setup(cell, seed, run)
    before = dict(detection.branch_counts)
    outputs = {}
    for i in range(cell.traffic['judged_calls']):
        outputs[i] = _call(state)
        state.calls += 1
    branches = {k: detection.branch_counts[k] - before[k] for k in before}
    free_program(state)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = reference_model(state, 'float32')
    out = [('program', dict(judge_outputs(state, outputs, model),
                            branches=branches))]
    if control:
        faults = MASKIOU_FAULTS if state.ref_cfg.use_maskiou else {}
        for name, fault in faults.items():
            planted = {i: fault(o) for i, o in outputs.items()}
            out.append(('fault_' + name,
                        judge_outputs(state, planted, model)))
        low = reference_model(state, 'bfloat16')
        for side, fp8 in (('control_fp8', True), ('reference_bf16', False)):
            outputs = {}
            for i in range(cell.traffic['judged_calls']):
                frames = torch.as_tensor(state.batch(i), device=state.dev)
                with torch.no_grad(), (fp8_operands() if fp8
                                       else contextlib.nullcontext()):
                    outputs[i] = forward_and_detect(
                        state.ref_cfg, low, frames, use_kernels=False)
            out.append((side, judge_outputs(state, outputs, model)))
    return out
