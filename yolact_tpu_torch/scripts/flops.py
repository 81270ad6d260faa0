"""Model FLOPs and MFU accounting: the port of ``scripts/flops.py``.

Counts the floating-point operations of the model's forward pass (per
image) and of the whole ``train/step.py:train_step`` (per step: forward,
backward, matcher, every loss, the SGD update) on the JAX script's dummy
batch, with ``torch.utils.flop_counter.FlopCounterMode``, and turns a
measured rate into MFU against a peak.

What the counter sees: convolutions (forward and both gradients) and
matrix products (``mm``, ``bmm``, ``addmm``, ``matmul``), 2 FLOPs a
multiply-add.  It misses everything else: elementwise work, batch norm,
activations, softmax, the resizes, reductions and the optimizer's
update, and the hand-written kernels' work (the DCN sampling, the s2d
stem kernel, mask assembly, the IoU max: their launches count as 0; the
DCN's GEMM is a ``torch.matmul`` and counts).  XLA's ``cost_analysis``,
which the JAX script reads, also counts elementwise work but counts only
the taps of a padded convolution that land inside its input, so the two
totals are not the same count and either can be the larger (padding
weighs more on small maps).

    python -m yolact_tpu_torch.scripts.flops [config ...] [--batch 1]
        [--train]            # forward in train mode (batch statistics)
        [--train-step]       # the whole train step, per step
        [--fps N]            # MFU for a measured rate (images/s, or
                             # steps/s with --train-step)
        [--peak-tflops 989]  # H100 SXM dense bf16
        [--dtype bfloat16]   # float32: MFU against dense TF32 (495) and
                             # float32 (67) beside it
        [--cuda False]       # count on the CPU

Prints one JSON line per config (with the card's name and power limit on
a card).
"""

from __future__ import annotations

import argparse
import json

# The card's data-sheet dense rates, TFLOP/s (H100 SXM at 700 W)
PEAK_TFLOPS = {'bfloat16': 989.0, 'tf32': 494.7, 'float32': 67.0}
COUNTER = 'torch.utils.flop_counter.FlopCounterMode'
# heads the inference forward does not run: the training-only heads, and
# the mask scorer, which JAX keeps out of its model (a separate
# MaskIoUHead) and which runs after detection
TRAIN_ONLY = ('semantic_seg_conv.', 'class_existence_fc.')
SEPARATE = ('maskiou_net.',)


def _count(fn):
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def _params(module, skip):
    return sum(p.numel() for n, p in module.named_parameters()
               if not n.startswith(skip))


def forward_flops(config_name: str, batch: int = 1, train: bool = False,
                  device='cuda:0') -> dict:
    """The model's forward pass on a zero [batch, 3, S, S] input, in
    inference or (``train``) with batch statistics; FLOPs per image.  The
    weights are the modules' own initial ones: the count does not depend
    on them (JAX's script counts on zeros)."""
    import torch

    from yolact_tpu_torch.config import get_config
    from yolact_tpu_torch.infer import check_device
    from yolact_tpu_torch.models.layers import drop_batch_stats
    from yolact_tpu_torch.models.yolact import Yolact

    device = check_device(device)
    cfg = get_config(config_name)
    model = Yolact(cfg)
    model.set_compute_dtype(getattr(torch, cfg.compute_dtype))
    model.to(device)
    S = cfg.max_size
    x = torch.zeros(batch, 3, S, S, device=device)
    if train:
        def run():
            model(x, train=True)
            drop_batch_stats(model)
    else:
        def run():
            with torch.inference_mode():
                model(x)
    flops = _count(run)
    skip = SEPARATE if train else SEPARATE + TRAIN_ONLY
    return {
        'config': config_name,
        'img_size': S,
        'batch': batch,
        'mode': 'train_fwd' if train else 'inference',
        'params_m': round(_params(model, skip) / 1e6, 2),
        'flops_per_image_g': round(flops / batch / 1e9, 2),
        'bytes_accessed_gb': None,
        'counter': COUNTER,
    }


def dummy_batch(cfg, batch: int = 8, max_gt: int = 32) -> dict:
    """The JAX script's dummy batch in the port's batch contract: zero
    images, every gt box [0.1, 0.1, 0.6, 0.6] with label 1 and a
    full-resolution zero mask, max_gt - 1 gts of which one crowd."""
    import numpy as np
    S, G = cfg.max_size, max_gt
    return dict(
        image=np.zeros((batch, S, S, 3), np.float32),
        gt_boxes=np.tile(np.asarray([[0.1, 0.1, 0.6, 0.6]], np.float32)[None],
                         (batch, G, 1)),
        gt_labels=np.ones((batch, G), np.int32),
        gt_masks=np.zeros((batch, G, S, S), np.uint8),
        num_gts=np.full(batch, G - 1, np.int32),
        num_crowds=np.ones(batch, np.int32))


def train_step_flops(config_name: str, batch: int = 8, max_gt: int = 32,
                     device='cuda:0') -> dict:
    """The whole train step (forward, backward, matcher, every loss, the
    SGD update) on :func:`dummy_batch`; FLOPs per step and per image."""
    import torch

    from yolact_tpu_torch.config import get_config
    from yolact_tpu_torch.train.step import create_train_state, train_step

    cfg = get_config(config_name)
    state = create_train_state(cfg, device=device)
    data = dummy_batch(cfg, batch, max_gt)
    gen = torch.Generator(device=state.device).manual_seed(0)
    flops = _count(lambda: train_step(state, data, gen))
    n_params = sum(p.numel() for p in state.model.parameters()
                   if p.requires_grad)
    return {
        'config': config_name,
        'img_size': cfg.max_size,
        'batch': batch,
        'mode': 'train_step',
        'params_m': round(n_params / 1e6, 2),
        'flops_per_step_g': round(flops / 1e9, 2),
        'flops_per_image_g': round(flops / batch / 1e9, 2),
        'bytes_accessed_gb': None,
        'counter': COUNTER,
    }


def add_mfu(row, fps, rate_key, peak_tflops, dtype):
    """`row` with the sustained rate of `fps` against `peak_tflops` (and,
    for float32, against dense TF32 and float32 beside it)."""
    sustained = row[rate_key] * 1e9 * fps
    row['fps'] = fps
    row['mfu_pct'] = round(sustained / (peak_tflops * 1e12) * 100, 2)
    row['peak_tflops'] = peak_tflops
    if dtype == 'float32':
        for kind in ('tf32', 'float32'):
            row[f'mfu_pct_{kind}'] = round(
                sustained / (PEAK_TFLOPS[kind] * 1e12) * 100, 2)
    return row


def _str2bool(v):
    return v if isinstance(v, bool) else v.lower() in ('yes', 'true', 't', '1')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('configs', nargs='*', default=['yolact_base'])
    ap.add_argument('--batch', type=int, default=1)
    ap.add_argument('--train', action='store_true',
                    help='forward pass in train mode (BN stats); use '
                         '--train-step for the full optimizer step')
    ap.add_argument('--train-step', action='store_true',
                    help='full train step: fwd+bwd+matcher+losses+SGD')
    ap.add_argument('--fps', type=float, default=None,
                    help='measured img/s (steps/s with --train-step) -> MFU')
    ap.add_argument('--peak-tflops', type=float,
                    default=PEAK_TFLOPS['bfloat16'],
                    help='peak (H100 SXM dense bf16 = 989)')
    ap.add_argument('--dtype', default='bfloat16',
                    help='the compute dtype the rate was measured in '
                         '(float32 adds MFU against TF32 and float32)')
    ap.add_argument('--cuda', default=True, type=_str2bool,
                    help='count on cuda:0 (False: on the CPU)')
    args = ap.parse_args(argv)

    from yolact_tpu_torch.utils.nvinfo import name_and_power_limit
    device = 'cuda:0' if args.cuda else 'cpu'
    card = name_and_power_limit() if args.cuda else None
    rows = []
    for name in (args.configs or ['yolact_base']):
        if args.train_step:
            row = train_step_flops(name, args.batch, device=device)
            rate_key = 'flops_per_step_g'
        else:
            row = forward_flops(name, args.batch, args.train, device=device)
            rate_key = 'flops_per_image_g'
        if args.fps:
            add_mfu(row, args.fps, rate_key, args.peak_tflops, args.dtype)
        if card:
            row['card'] = card
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == '__main__':
    main()
