"""COCO-format detections JSON writer (+ web-viewer JSON).

The port's copy of ``yolact_tpu/eval/coco_json.py``.

Parity with the reference ``Detections`` class (``eval.py:300-371``): bbox
results rounded to 0.1 px, segmentation as compressed RLE (our native codec
instead of pycocotools), category ids mapped back through the inverse label
map (``eval.py:283-297``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from yolact_tpu_torch.config import DatasetConfig, YolactConfig
from yolact_tpu_torch.data import rle as rle_codec


def inverse_label_map(dataset: DatasetConfig) -> Dict[int, int]:
    """0-based transformed class -> original COCO category id."""
    lm = dataset.label_map_dict
    if lm is None:
        lm = {x + 1: x + 1 for x in range(len(dataset.class_names))}
    return {v - 1: k for k, v in lm.items()}


class DetectionsWriter:
    def __init__(self, cfg: YolactConfig):
        self.cfg = cfg
        self.coco_cats = inverse_label_map(cfg.dataset)
        self.bbox_data: List[dict] = []
        self.mask_data: List[dict] = []

    def add_bbox(self, image_id: int, category_id: int, bbox, score: float):
        """bbox is (x1, y1, x2, y2) absolute pixels."""
        b = [bbox[0], bbox[1], bbox[2] - bbox[0], bbox[3] - bbox[1]]
        b = [round(float(x) * 10) / 10 for x in b]
        self.bbox_data.append({
            'image_id': int(image_id),
            'category_id': self.coco_cats[int(category_id)],
            'bbox': b,
            'score': float(score),
        })

    def add_mask(self, image_id: int, category_id: int,
                 segmentation: np.ndarray, score: float):
        rle = rle_codec.mask_to_rle(segmentation.astype(bool))
        self.mask_data.append({
            'image_id': int(image_id),
            'category_id': self.coco_cats[int(category_id)],
            'segmentation': {'size': rle['size'],
                             'counts': rle['counts'].decode('ascii')},
            'score': float(score),
        })

    def dump(self, bbox_det_file: str, mask_det_file: str):
        for data, path in ((self.bbox_data, bbox_det_file),
                           (self.mask_data, mask_det_file)):
            with open(path, 'w') as f:
                json.dump(data, f)

    def dump_web(self, web_det_path: str):
        """Web-viewer JSON (eval.py:342-371)."""
        cfg = self.cfg
        config_outs = ['preserve_aspect_ratio', 'use_prediction_module',
                       'use_yolo_regressors', 'use_prediction_matching',
                       'train_masks']
        output = {'info': {
            'Config': {k: getattr(cfg, k) for k in config_outs}}}

        image_ids = sorted(set(x['image_id'] for x in self.bbox_data))
        lookup = {_id: i for i, _id in enumerate(image_ids)}
        output['images'] = [{'image_id': i, 'dets': []} for i in image_ids]

        inv = {v: k for k, v in self.coco_cats.items()}
        for bbox, mask in zip(self.bbox_data, self.mask_data):
            output['images'][lookup[bbox['image_id']]]['dets'].append({
                'score': bbox['score'],
                'bbox': bbox['bbox'],
                'category': cfg.dataset.class_names[inv[bbox['category_id']]],
                'mask': mask['segmentation'],
            })
        os.makedirs(web_det_path, exist_ok=True)
        with open(os.path.join(web_det_path, f'{cfg.name}.json'), 'w') as f:
            json.dump(output, f)
