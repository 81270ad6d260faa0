"""Long-horizon training from random weights on a generated, learnable
shapes set, then its mAP: the port of ``scripts/train_horizon.py``.

The set is the JAX script's, made in memory: 64 images of 640x480 (coloured
shapes on textured backgrounds, 8 categories keyed by shape x colour), the
same ``np.random.RandomState(seed)`` draws in the same order, so every
shape, colour, position and annotation is the same number.  It goes to the
port's trainer (``cli/train.py:train(argv, dataset=, val_dataset=)``) as
in-memory sets that yield what ``data/coco.py:COCODetection.pull_item``
yields for the JAX script's files (``SSDAugmentation`` for training,
``BaseTransform`` for eval), because reading those files needs cv2.
Deltas from the JAX script:

- No JPEG: JAX writes each image as a JPEG and trains on what
  ``cv2.imread`` reads back; here the trainer gets the exact BGR array
  (JAX's RGB drawing, ``img[:, :, ::-1]``), without JPEG's loss.
- The polygons are filled by :func:`fill_polygon`, a numpy copy of
  ``cv2.fillPoly`` for integer vertices (its scanline fill and its
  8-connected edge lines), for the drawn shape and for its mask alike.
- Outputs go under ``results/torch_horizon/`` and checkpoints under
  ``weights/torch_horizon/`` (``--out_dir``, ``--save_folder``); the JAX
  run's committed ``results/horizon_logs/`` and ``results/horizon_*.json``
  are only read, for the loss letters beside the port's.
- ``--cuda`` (default True: ``cuda:0``; False: the CPU), as the CLIs take.
- After training, and with ``--plot_only``, it prints each loss letter's
  mean over each block of 200 iterations from its own log and from JAX's
  committed log of the same config, so the curves compare where there is
  no matplotlib.

The schedule is the config's (lr 1e-3, 500-iteration warmup from 1e-4),
SGD with momentum and weight decay, bf16 compute over f32 weights, host
augmentation on 4 loader workers: JAX's flags.

    python -m yolact_tpu_torch.scripts.train_horizon yolact_plus_resnet50 --iters 1200
    python -m yolact_tpu_torch.scripts.train_horizon yolact_plus_resnet50 --iters 2400 --resume latest
    python -m yolact_tpu_torch.scripts.train_horizon yolact_plus_resnet50 \\
        --eval weights/torch_horizon/yolact_plus_resnet50_horizon_299_2400.pth
    python -m yolact_tpu_torch.scripts.train_horizon yolact_plus_resnet50 --plot_only

Writes ``<out_dir>/horizon_logs/<config>_horizon.log`` (the trainer's
JSONL log), ``<out_dir>/horizon_<config>_<start>_<end>.json`` (a
segment's wall time, median ms per iteration, peak memory and card),
``<out_dir>/horizon_map_<config>_<iter>.json`` (``--eval``) and
``<out_dir>/horizon_<config>.png`` (the plot, where matplotlib exists).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np

from yolact_tpu_torch.data.coco import (COCOAnnotationTransform,
                                        COCODetection, COCOIndex)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the JAX run's committed log of `<config>_horizon`, read for comparison
JAX_LOG = os.path.join(REPO, 'results', 'horizon_logs', '{}_horizon.log')
OUT_DIR = 'results/torch_horizon'
SAVE_FOLDER = 'weights/torch_horizon/'
# where the set would lie on disk: the config names it, nothing reads it
DATA_DIR = 'results/torch_horizon/data'

# shape x color -> category id 1..8 (all valid COCO ids, so the stock
# coco2017 label_map and 81-class head are exercised unchanged)
SHAPES = ('rect', 'circle', 'triangle', 'ellipse')
COLORS = ((235, 80, 60), (70, 140, 235))  # warm / cool

XY_SHIFT = 16       # cv2's fixed-point x of a polygon edge


def _line_pixels(p0, p1):
    """The pixels (xs, ys) of cv2's 8-connected line from `p0` to `p1`
    (integer points; ``LineIterator`` walked left to right): one pixel per
    step of the major axis, a step of the minor one where Bresenham's
    error goes negative, i.e. at offset ceil((2 i dmin - dmaj) / 2 dmaj)."""
    (x0, y0), (x1, y1) = (int(v) for v in p0), (int(v) for v in p1)
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    dmaj, dmin = (dy, dx) if dy > dx else (dx, dy)
    i = np.arange(dmaj + 1, dtype=np.int64)
    minor = -((dmaj - 2 * i * dmin) // (2 * dmaj)) if dmaj else i
    if dy > dx:
        return x0 + minor, y0 + sy * i
    return x0 + i, y0 + sy * minor


def fill_polygon(canvas, pts, value):
    """Fill the polygon `pts` ([n, 2] integer x, y) on `canvas` ([h, w] or
    [h, w, c]) with `value`, as ``cv2.fillPoly(canvas, [pts], value)`` does
    with 8-connected lines and no shift: each edge drawn as its line, then
    every scanline from the top vertex's row to the bottom one's (that row
    excluded) filled between consecutive crossings of the non-horizontal
    edges, each edge's x in 16-bit fixed point from its top vertex plus
    half a pixel, advancing by (dx << 16) / dy truncated toward zero, the
    span from the left crossing rounded to the right one less half a pixel
    floored (the rule that reproduces OpenCV 5.0's fill on 3000 random
    polygons, tests/test_torch_horizon.py).  Modifies `canvas` in
    place."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    h, w = canvas.shape[:2]
    prev = pts[np.arange(len(pts)) - 1]
    for a, b in zip(prev, pts):
        xs, ys = _line_pixels(a, b)
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        canvas[ys[keep], xs[keep]] = value
    rows, xs = [], []
    for (x0, y0), (x1, y1) in zip(prev, pts):
        if y0 == y1:
            continue
        num, den = (x1 - x0) << XY_SHIFT, y1 - y0
        step = abs(num) // abs(den) * (1 if (num < 0) == (den < 0) else -1)
        (tx, ty), bottom = ((x0, y0), y1) if y0 < y1 else ((x1, y1), y0)
        y = np.arange(ty, bottom, dtype=np.int64)
        rows.append(y)
        xs.append((tx << XY_SHIFT) + (1 << (XY_SHIFT - 1)) + (y - ty) * step)
    if len(rows) < 2:
        return canvas
    rows, xs = np.concatenate(rows), np.concatenate(xs)
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    y = rows[0::2]
    lo = xs[0::2] >> XY_SHIFT
    hi = (xs[1::2] - (1 << (XY_SHIFT - 1))) >> XY_SHIFT
    keep = (y >= 0) & (y < h) & (lo < w) & (hi >= 0) & (lo <= hi)
    y, lo, hi = y[keep], np.maximum(lo[keep], 0), np.minimum(hi[keep], w - 1)
    if not len(y):
        return canvas
    # the spans as +1 / -1 marks summed along each row, in their bounding box
    y0, x0 = y.min(), lo.min()
    marks = np.zeros((y.max() - y0 + 1, hi.max() - x0 + 2), np.int32)
    np.add.at(marks, (y - y0, lo - x0), 1)
    np.add.at(marks, (y - y0, hi + 1 - x0), -1)
    inside = np.cumsum(marks, axis=1)[:, :-1] > 0
    canvas[y0:y0 + inside.shape[0], x0:x0 + inside.shape[1]][inside] = value
    return canvas


def _draw_object(img, rng, shape, color):
    """Draw one filled shape; return (poly_xy list, bbox xywh).  The JAX
    script's draws, in its order."""
    h, w = img.shape[:2]
    cx = int(rng.randint(60, w - 60))
    cy = int(rng.randint(60, h - 60))
    sx = int(rng.randint(25, 90))
    sy = int(rng.randint(25, 90))
    if shape == 'rect':
        pts = np.array([[cx - sx, cy - sy], [cx + sx, cy - sy],
                        [cx + sx, cy + sy], [cx - sx, cy + sy]])
    elif shape == 'triangle':
        pts = np.array([[cx, cy - sy], [cx + sx, cy + sy], [cx - sx, cy + sy]])
    else:  # circle / ellipse as a 24-gon
        t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
        rx, ry = (sx, sx) if shape == 'circle' else (sx, sy)
        pts = np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], -1)
    pts = np.clip(np.round(pts), [0, 0], [w - 1, h - 1]).astype(np.int32)
    fill_polygon(img, pts, color)
    x0, y0 = pts.min(0)
    x1, y1 = pts.max(0)
    poly = [float(v) for xy in pts for v in xy]
    return poly, [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]


def make_dataset(n_images=64, width=640, height=480, seed=0):
    """The JAX script's synthetic COCO set in memory: ({image id: BGR uint8
    [height, width, 3]}, the instances dict JAX writes as JSON)."""
    rng = np.random.RandomState(seed)
    images, entries, annotations = {}, [], []
    ann_id = 1
    for i in range(n_images):
        img_id = 1000 + i
        # textured background: smooth 2-D gradient + mild noise
        gx = np.linspace(0, 1, width)[None, :]
        gy = np.linspace(0, 1, height)[:, None]
        base = (60 + 100 * (gx * rng.rand() + gy * rng.rand()))
        img = np.stack([base + rng.randn(height, width) * 8
                        for _ in range(3)], -1)
        img = np.clip(img, 0, 255).astype(np.uint8)
        for _ in range(int(rng.randint(3, 8))):
            si = int(rng.randint(len(SHAPES)))
            ci = int(rng.randint(len(COLORS)))
            poly, bbox = _draw_object(img, rng, SHAPES[si], COLORS[ci])
            if bbox[2] < 8 or bbox[3] < 8:
                continue
            annotations.append({
                'id': ann_id, 'image_id': img_id,
                'category_id': si * len(COLORS) + ci + 1,
                'bbox': bbox, 'area': bbox[2] * bbox[3], 'iscrowd': 0,
                'segmentation': [poly]})
            ann_id += 1
        name = f'{img_id:012d}.jpg'
        images[img_id] = np.ascontiguousarray(img[:, :, ::-1])
        entries.append({'id': img_id, 'file_name': name,
                        'width': width, 'height': height})
    cats = [{'id': si * len(COLORS) + ci + 1,
             'name': f'{SHAPES[si]}_{"warm" if ci == 0 else "cool"}'}
            for si in range(len(SHAPES)) for ci in range(len(COLORS))]
    return images, {'images': entries, 'annotations': annotations,
                    'categories': cats}


class HorizonIndex(COCOIndex):
    """``COCOIndex`` over an instances dict in memory, its polygons filled
    by :func:`fill_polygon` (a polygon annotation is what the set holds)."""

    def __init__(self, info):
        self.imgs = {im['id']: im for im in info['images']}
        self.cats = {c['id']: c for c in info['categories']}
        self.img_to_anns = {}
        for ann in info['annotations']:
            self.img_to_anns.setdefault(ann['image_id'], []).append(ann)

    def ann_to_mask(self, ann, h, w):
        mask = np.zeros((h, w), np.uint8)
        for poly in ann['segmentation']:
            if len(poly) >= 6:
                pts = np.asarray(poly, np.float64).reshape(-1, 2)
                fill_polygon(mask, pts.round().astype(np.int64), 1)
        return mask.astype(bool)


class HorizonDataset(COCODetection):
    """``COCODetection`` over :func:`make_dataset`'s arrays: the same
    ``pull_item`` (crowds last, ``COCOAnnotationTransform``, `transform`),
    with the image read from memory instead of a file."""

    def __init__(self, images, info, transform, dataset_cfg):
        # the base's fields, its index built from `info` instead of a file
        self.root = None
        self.coco = HorizonIndex(info)
        self.ids = list(self.coco.img_to_anns.keys()) or \
            list(self.coco.imgs.keys())
        self.images = images
        self.transform = transform
        self.target_transform = COCOAnnotationTransform(dataset_cfg)
        self.name = 'horizon shapes'
        self.has_gt = True

    def _load_image(self, img_id):
        return self.images[img_id].copy()


def horizon_datasets(cfg, n_images=64, seed=0):
    """(training set with SSDAugmentation, eval set with BaseTransform), one
    shapes set made by :func:`make_dataset`, as the JAX script trains and
    evaluates on the same files."""
    from yolact_tpu_torch.data.augmentations import (BaseTransform,
                                                     SSDAugmentation)
    images, info = make_dataset(n_images, seed=seed)
    return (HorizonDataset(images, info, SSDAugmentation(cfg), cfg.dataset),
            HorizonDataset(images, info, BaseTransform(cfg), cfg.dataset))


def horizon_config(config, iters, dataset=DATA_DIR):
    """``<config>_horizon``: `config` with `iters` iterations and its train
    and validation sets at `dataset`'s ``images/`` and ``instances.json``
    (the JAX script's :183-194)."""
    from yolact_tpu_torch.config import get_config
    base = get_config(config)
    img_dir = os.path.join(dataset, 'images')
    json_path = os.path.join(dataset, 'instances.json')
    return base.copy(
        name=f'{config}_horizon', max_iter=iters,
        dataset=base.dataset.copy(
            train_images=img_dir, train_info=json_path,
            valid_images=img_dir, valid_info=json_path))


def trainer_argv(args):
    """The trainer's flags for `args` (the JAX script's :209-222, with
    ``--cuda False`` where the CPU is asked for)."""
    argv = ['--config', f'{args.config}_horizon',
            '--batch_size', str(args.batch),
            '--compute_dtype', args.dtype, '--num_workers', '4',
            '--validation_epoch', '0', '--save_interval', '1000000',
            '--log_folder', os.path.join(args.out_dir, 'horizon_logs'),
            '--save_folder', args.save_folder]
    if args.lr is not None:
        argv += ['--lr', str(args.lr)]
    if args.resume is not None:
        argv += ['--resume', args.resume, '--start_iter', '-1']
    if not args.cuda:
        argv += ['--cuda', 'False']
    return argv


def loss_blocks(log_path, block=200):
    """Each loss letter's mean, and their total's, over each block of
    `block` iterations of a JSONL training log: [(first, last, {letter:
    mean, 'total': mean}, entries)].  An iteration logged twice (a segment
    run again) counts once, with its last entry."""
    by_iter = {}
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            e = json.loads(line)
            if e.get('type') == 'train':
                by_iter[e['data']['iter']] = e['data']['loss']
    groups = {}
    for it, loss in sorted(by_iter.items()):
        groups.setdefault((it - 1) // block, []).append(loss)
    out = []
    for k, losses in sorted(groups.items()):
        letters = sorted(losses[0])
        means = {c: statistics.fmean(l[c] for l in losses) for c in letters}
        means['total'] = statistics.fmean(sum(l.values()) for l in losses)
        out.append((k * block + 1, (k + 1) * block, means, len(losses)))
    return out


def print_loss_blocks(log_path, jax_log, block=200):
    """Print :func:`loss_blocks` of the port's log beside the JAX run's, and
    the total over the first and the last 100 iterations of each."""
    sides = [('port', log_path), ('JAX', jax_log)]
    tables = {}
    for side, path in sides:
        blocks = loss_blocks(path, block) if os.path.exists(path) else []
        if blocks:
            tables[side] = {b[0]: b for b in blocks}
        else:
            print(f'({side} log {path}: no training entries)')
    if not tables:
        return tables
    letters = sorted({c for t in tables.values() for b in t.values()
                      for c in b[2]} - {'total'}) + ['total']
    print(f'loss letters, mean over each {block} iterations: '
          + '; '.join(f'{s} {p}' for s, p in sides if s in tables))
    head = ' '.join(f'{c:>7s}' for c in letters)
    print(f'{"iterations":>11s} | ' + ' | '.join(
        f'{s + " " + head:>{len(head)}s}' for s in tables))
    for first in sorted({k for t in tables.values() for k in t}):
        cells = []
        for side in tables:
            b = tables[side].get(first)
            cells.append(' '.join(
                f'{b[2][c]:7.3f}' if b and c in b[2] else f'{"-":>7s}'
                for c in letters))
        print(f'{first:5d}-{first + block - 1:<5d} | ' + ' | '.join(cells))
    for side, path in sides:
        if side in tables:
            edges = loss_blocks(path, 100)
            print(f'{side} total loss, iterations {edges[0][0]}-'
                  f'{edges[0][1]}: {edges[0][2]["total"]!r}; iterations '
                  f'{edges[-1][0]}-{edges[-1][1]}: {edges[-1][2]["total"]!r}')
    return tables


def plot_log(log_path, out_png):
    """Loss-letter curves + lr from the JSONL log via LogVisualizer."""
    from yolact_tpu_torch.utils.logger import LogVisualizer
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    vis = LogVisualizer()
    vis.load(log_path)
    iters = vis.query('data.iter', 'train')
    if not iters:
        raise SystemExit(f'no train entries in {log_path} — did the run '
                         'reach the first log interval?')
    letters = sorted(vis.query('data.loss', 'train')[0].keys())
    fig, (ax, ax2) = plt.subplots(
        2, 1, figsize=(9, 7), sharex=True,
        gridspec_kw={'height_ratios': [3, 1]})
    for letter in letters:
        pairs = vis.query_joined(('data.iter', f'data.loss.{letter}'),
                                 'train')
        if pairs:
            xs, ys = zip(*pairs)
            ax.plot(xs, ys, label=letter, linewidth=1.0)
    totals = vis.query_joined(
        ('data.iter', lambda e: sum(e['data']['loss'].values())), 'train')
    if totals:
        xs, ys = zip(*totals)
        ax.plot(xs, ys, label='total', color='k', linewidth=1.8)
    ax.set_yscale('log')
    ax.set_ylabel('loss')
    ax.legend(ncol=4, fontsize=8)
    ax.set_title(os.path.basename(log_path))
    lr_pairs = vis.query_joined(('data.iter', 'data.lr'), 'train')
    if lr_pairs:
        xs, lrs = zip(*lr_pairs)
        ax2.plot(xs, lrs, color='tab:gray')
    ax2.set_ylabel('lr')
    ax2.set_xlabel('iteration')
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    print(f'wrote {out_png}')


def evaluate_checkpoint(cfg, path, dataset, batch=8, device='cuda:0',
                        use_kernels=True, compute_dtype=None, quiet=False):
    """The checkpoint at `path` (a port ``.pth`` or a JAX ``.ckpt``) through
    the whole eval on `dataset`: forward, detection, masks, AP matching,
    the mAP table.  Returns the all_maps dict."""
    from yolact_tpu_torch.eval.evaluate import evaluate_dataset
    from yolact_tpu_torch.train.checkpoint import load_weights
    weights = load_weights(cfg, path)
    return evaluate_dataset(cfg, weights, dataset, device=device,
                            compute_dtype=compute_dtype,
                            eval_batch_size=batch, use_kernels=use_kernels,
                            quiet=quiet, no_bar=True)


def _str2bool(v):
    return v if isinstance(v, bool) else v.lower() in ('yes', 'true', 't', '1')


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('config', nargs='?', default='yolact_base')
    ap.add_argument('--iters', type=int, default=1000)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--images', type=int, default=64)
    ap.add_argument('--lr', type=float, default=None,
                    help='override lr (default: config schedule)')
    ap.add_argument('--dtype', default='bfloat16')
    ap.add_argument('--out_dir', default=OUT_DIR)
    ap.add_argument('--save_folder', default=SAVE_FOLDER)
    ap.add_argument('--plot_only', action='store_true')
    ap.add_argument('--eval', metavar='CKPT', default=None,
                    help='skip training; evaluate this horizon checkpoint '
                         'on the synthetic set (full eval->mAP loop)')
    ap.add_argument('--resume', default=None,
                    help="passed through to the trainer ('latest' resumes "
                         'the newest horizon checkpoint)')
    ap.add_argument('--cuda', default=True, type=_str2bool,
                    help='run on cuda:0 (False: on the CPU)')
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from yolact_tpu_torch.config import register_config
    from yolact_tpu_torch.infer import check_device
    from yolact_tpu_torch.utils.nvinfo import name_and_power_limit

    name = f'{args.config}_horizon'
    out_dir = args.out_dir
    if os.path.abspath(out_dir) == os.path.join(REPO, 'results'):
        raise SystemExit(f'--out_dir {out_dir}: the JAX run\'s committed '
                         f'horizon artifacts live there; pick another')
    log_path = os.path.join(out_dir, 'horizon_logs', name + '.log')
    jax_log = JAX_LOG.format(args.config)
    if args.plot_only:
        print_loss_blocks(log_path, jax_log)
        plot_log(log_path, os.path.join(out_dir,
                                        f'horizon_{args.config}.png'))
        return None

    device = check_device('cuda:0' if args.cuda else 'cpu')
    cfg = register_config(horizon_config(args.config, args.iters))
    train_set, val_set = horizon_datasets(cfg, args.images)
    os.makedirs(out_dir, exist_ok=True)
    card = name_and_power_limit() if device.type == 'cuda' else None

    if args.eval:
        maps = evaluate_checkpoint(cfg, args.eval, val_set, args.batch,
                                   device)
        from yolact_tpu_torch.utils.functions import SavePath
        step = SavePath.from_str(args.eval).iteration
        out = os.path.join(out_dir, f'horizon_map_{args.config}_{step}.json')
        with open(out, 'w') as f:
            json.dump({'checkpoint': os.path.basename(args.eval),
                       'maps': maps, 'card': card}, f, indent=1)
        print(f'wrote {out} [{card or device}]')
        return maps

    from yolact_tpu_torch.cli.train import train
    import torch
    t0 = time.perf_counter()
    summary = train(trainer_argv(args), dataset=train_set,
                    val_dataset=val_set)
    wall = time.perf_counter() - t0
    iters = summary['iter_seconds']
    report = dict(
        config=name, start=summary['start_iter'],
        end=summary['iteration'], checkpoint=summary['path'],
        # the median iteration, the first two (warm-up) left out
        wall_s=wall, ms_per_iter_median=statistics.median(
            iters[2:] or iters) * 1e3,
        loader_wait_share=sum(summary['wait_seconds']) / sum(iters)
        if iters else None,
        # the process's peak: the segment is all it has run on the card
        peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30
        if device.type == 'cuda' else None,
        card=card, device=str(device))
    out = os.path.join(out_dir, f'horizon_{args.config}_'
                                f'{report["start"]}_{report["end"]}.json')
    with open(out, 'w') as f:
        json.dump(report, f, indent=1)
    print(f'horizon segment: {json.dumps(report)}')
    print_loss_blocks(log_path, jax_log)
    if importlib.util.find_spec('matplotlib') is None:
        print('(no matplotlib here: plot with --plot_only where it is)')
    elif loss_blocks(log_path):
        plot_log(log_path, os.path.join(out_dir,
                                        f'horizon_{args.config}.png'))
    return summary


if __name__ == '__main__':
    main(sys.argv[1:])
