"""mAP-risk A/B over the knobs that change behaviour: the port of
``scripts/map_ab.py``.

Runs the whole dataset eval (forward, detection, masks, AP matching, the
mAP table) of one checkpoint on the horizon's synthetic set
(``scripts/train_horizon.py``'s, made in memory) and prints a table:

- ``nms_candidates``: 0 (exact) against 1024 (the pruned path) and 8
  (forces the crowded-batch fallback): must be equal;
- the trunk in float32 and in bfloat16: the delta is reported, not held;
- mask assembly (with the other kernels) through the hand-written kernels
  and through their plain PyTorch versions (``use_kernels``, the switch
  ``chip_smoke.py`` phase 4 uses): must be equal.  On the CPU both rows
  take the plain versions.

Exit code 1 (``DIRTY``) when an ``nms_candidates`` row differs from the
exact row or the kernel row from the plain row.  Delta from the JAX
script: JAX overfits a tiny model itself; this one evaluates a checkpoint
(a port ``.pth`` or a JAX ``.ckpt``), the horizon's, on the horizon's set
(:func:`ab_rows` takes any config, weights and dataset).  The mask IoU of
the table runs on the card there (``eval/device_metrics.py``, the host's
matrices bit for bit) and on the host on the CPU, where JAX always takes
the host.

    python -m yolact_tpu_torch.scripts.map_ab \\
        weights/torch_horizon/yolact_plus_resnet50_horizon_299_2400.pth
    python -m yolact_tpu_torch.scripts.map_ab CKPT --cuda False
"""

from __future__ import annotations

import argparse
import sys

# the rows of the table, by name: (config overrides, evaluate_dataset
# keywords); the first is the exact row the nms_candidates rows are held
# to, the last two the kernel and plain rows
ROWS = (
    ('nms_candidates=0 (exact)', dict(nms_candidates=0), {}),
    ('nms_candidates=1024', dict(nms_candidates=1024), {}),
    ('nms_candidates=8 (fallback)', dict(nms_candidates=8), {}),
    ('trunk float32', dict(compute_dtype='float32'), {}),
    ('trunk bfloat16', dict(compute_dtype='bfloat16'), {}),
    ('mask assembly kernel/default', {}, dict(use_kernels=True)),
    ('mask assembly plain', {}, dict(use_kernels=False)),
)
NMS_ROWS = ROWS[1:3]


def ab_rows(cfg, weights, dataset, device='cuda:0', batch=8):
    """Each row's all_maps dict: [(name, maps)] in ROWS' order."""
    from yolact_tpu_torch.eval.evaluate import evaluate_dataset
    out = []
    for name, overrides, kw in ROWS:
        maps = evaluate_dataset(cfg.copy(**overrides), weights, dataset,
                                device=device, eval_batch_size=batch,
                                quiet=True, no_bar=True, **kw)
        out.append((name, maps))
    return out


def verdict(rows):
    """(clean, the lines to print): JAX's table and its CLEAN/DIRTY line,
    with the bfloat16 trunk's delta from float32."""
    maps = dict(rows)
    lines = [f'{"knob":32s} {"box mAP":>8s} {"mask mAP":>9s}']
    for name, m in rows:
        lines.append(f'{name:32s} {m["box"]["all"]:8.2f} '
                     f'{m["mask"]["all"]:9.2f}')
    ok = True
    exact = maps[ROWS[0][0]]
    for name, _, _ in NMS_ROWS:
        if maps[name] != exact:
            ok = False
            lines.append(f'MISMATCH: {name} != exact')
    if maps[ROWS[5][0]] != maps[ROWS[6][0]]:
        ok = False
        lines.append('MISMATCH: kernel vs plain mask assembly')
    f32, bf16 = maps['trunk float32'], maps['trunk bfloat16']
    lines.append('bfloat16 - float32 trunk: ' + ', '.join(
        f'{t} {bf16[t]["all"] - f32[t]["all"]:+.4f}' for t in ('box', 'mask'))
        + ' mAP (reported, not held)')
    lines.append('A/B ' + ('CLEAN' if ok else 'DIRTY'))
    return ok, lines


def _str2bool(v):
    return v if isinstance(v, bool) else v.lower() in ('yes', 'true', 't', '1')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('checkpoint',
                    help='a horizon checkpoint (.pth, or a JAX .ckpt)')
    ap.add_argument('--config', default=None,
                    help="the horizon's base config (default: the "
                         "checkpoint's name less '_horizon')")
    ap.add_argument('--images', type=int, default=64)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--cuda', default=True, type=_str2bool,
                    help='run on cuda:0 (False: on the CPU)')
    args = ap.parse_args(argv)

    from yolact_tpu_torch.config import register_config
    from yolact_tpu_torch.infer import check_device
    from yolact_tpu_torch.scripts.train_horizon import (horizon_config,
                                                        horizon_datasets)
    from yolact_tpu_torch.train.checkpoint import load_weights
    from yolact_tpu_torch.utils.functions import SavePath
    from yolact_tpu_torch.utils.nvinfo import name_and_power_limit

    device = check_device('cuda:0' if args.cuda else 'cpu')
    config = args.config or SavePath.from_str(
        args.checkpoint).model_name.rsplit('_horizon', 1)[0]
    cfg = register_config(horizon_config(config, 1))
    _, dataset = horizon_datasets(cfg, args.images)
    rows = ab_rows(cfg, load_weights(cfg, args.checkpoint), dataset, device,
                   args.batch)
    ok, lines = verdict(rows)
    card = name_and_power_limit() if device.type == 'cuda' else None
    print(f'mAP A/B of {args.checkpoint} on {len(dataset)} synthetic '
          f'images, b{args.batch} [{card or device}]')
    print('\n'.join(lines))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
