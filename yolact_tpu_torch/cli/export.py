"""Export the full inference program as one ``.pt2`` artifact (weights
inside): the port's ``yolact_tpu/cli/export.py``.

    python -m yolact_tpu_torch.cli.export \\
        --trained_model=weights/yolact_base_54_800000.pth \\
        --out=yolact_base.pt2 --batch_size=1 [--cuda=False] [--selftest]

The weights are a port checkpoint, a reference ``.pth`` or a JAX ``.ckpt``
(``train/checkpoint.py:load_weights``); the config is parsed from the file
name unless ``--config`` names it.  The artifact runs on the device it was
exported on: ``--cuda`` (default True, ``cuda:0``) or the CPU, in place of
JAX's ``--platforms``.  Loading it needs torch and ``yolact_tpu_torch`` (the
kernels' custom ops); see ``convert/export.py``.
"""

from __future__ import annotations

import argparse
import os

from yolact_tpu_torch.cli.eval import str2bool


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='YOLACT export (PyTorch port)')
    p.add_argument('--trained_model', required=True, type=str)
    p.add_argument('--config', default=None, type=str)
    p.add_argument('--out', required=True, type=str)
    p.add_argument('--batch_size', default=1, type=int)
    p.add_argument('--height', default=None, type=int)
    p.add_argument('--width', default=None, type=int)
    p.add_argument('--cuda', default=True, type=str2bool,
                   help='export for cuda:0 (False: for the CPU); the '
                        'artifact runs on that device')
    p.add_argument('--score_threshold', default=0.0, type=float)
    p.add_argument('--selftest', action='store_true',
                   help='reload the artifact and run a zero batch')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from yolact_tpu_torch.config import config_from_model_path, get_config
    from yolact_tpu_torch.convert.export import export_inference, load_exported
    from yolact_tpu_torch.train.checkpoint import load_weights

    if args.config is None:
        cfg = config_from_model_path(args.trained_model)
        print(f'Config not specified. Parsed {cfg.name}_config from the '
              f'file name.\n')
    else:
        cfg = get_config(args.config)

    export_inference(cfg, load_weights(cfg, args.trained_model), args.out,
                     batch_size=args.batch_size, height=args.height,
                     width=args.width,
                     device='cuda:0' if args.cuda else 'cpu',
                     score_threshold=args.score_threshold)
    print(f'Exported {args.out} '
          f'({os.path.getsize(args.out) / 1e6:.1f} MB)')

    if args.selftest:
        import torch
        runner = load_exported(args.out)
        m = runner.meta
        out = runner(torch.zeros((m['batch'], m['height'], m['width'], 3)))
        print('selftest ok:', [tuple(o.shape) for o in out])


if __name__ == '__main__':
    main()
