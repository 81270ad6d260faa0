"""COCO-protocol evaluation of detection result JSONs, pycocotools-free.

    python -m yolact_tpu_torch.cli.coco_eval \
        --gt_ann_file=data/coco/annotations/instances_val2017.json \
        --bbox_det_file=results/bbox_detections.json \
        --mask_det_file=results/mask_detections.json

The port's form of the repo's ``run_coco_eval.py`` (the reference's
``run_coco_eval.py``, which feeds ``--output_coco_json``'s files to
pycocotools): the same flags and printout, through the port's copy of the
COCOeval protocol (``eval/cocoeval.py``).  Host only: no device is used.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from yolact_tpu_torch.eval.cocoeval import COCOEvalLite


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='COCO result-json evaluation')
    p.add_argument('--bbox_det_file', default='results/bbox_detections.json')
    p.add_argument('--mask_det_file', default='results/mask_detections.json')
    p.add_argument('--gt_ann_file',
                   default='data/coco/annotations/instances_val2017.json')
    p.add_argument('--eval_type', default='both',
                   choices=('both', 'bbox', 'mask'))
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Prints the 12 COCO numbers of each evaluated type and returns them
    by type ('bbox', 'segm')."""
    args = parse_args(argv)
    stats = {}
    if args.eval_type in ('both', 'bbox'):
        print('\nEvaluating BBoxes:')
        stats['bbox'] = COCOEvalLite(args.gt_ann_file, args.bbox_det_file,
                                     'bbox').evaluate()
    if args.eval_type in ('both', 'mask'):
        print('\nEvaluating Masks:')
        stats['segm'] = COCOEvalLite(args.gt_ann_file, args.mask_det_file,
                                     'segm').evaluate()
    return stats


if __name__ == '__main__':
    main()
