"""COCO detection dataset, pycocotools-free: the eval side of
``yolact_tpu/data/coco.py`` (``COCOIndex``, ``COCOAnnotationTransform``,
``COCODetection``), copied for the port.  The training batch helpers
(``pad_batch``, ``pack_batch_masks``, ``enforce_size``) come with the train
step.

Crowd annotations are moved to the tail with ``category_id = -1``
(reference ``data/coco.py:119-130``); a transform that drops all gt
triggers a resample (``data/coco.py:172-174``).  cv2 is imported only
where an image is read.
"""

from __future__ import annotations

import json
import os.path as osp
import random as _random
from typing import Dict, List, Optional, Sequence

import numpy as np

from yolact_tpu_torch.config import DatasetConfig
from yolact_tpu_torch.data import rle as rle_codec


class COCOIndex:
    """Minimal COCO instances-json index: images, per-image anns, categories."""

    def __init__(self, info_file: str):
        with open(info_file) as f:
            d = json.load(f)
        self.imgs: Dict[int, dict] = {im['id']: im for im in d.get('images', [])}
        self.cats: Dict[int, dict] = {c['id']: c
                                      for c in d.get('categories', [])}
        self.img_to_anns: Dict[int, List[dict]] = {}
        for ann in d.get('annotations', []):
            self.img_to_anns.setdefault(ann['image_id'], []).append(ann)

    def ann_to_mask(self, ann: dict, h: int, w: int) -> np.ndarray:
        return rle_codec.ann_to_mask(ann['segmentation'], h, w)


class COCOAnnotationTransform:
    """[x, y, w, h] COCO boxes -> normalized [x1, y1, x2, y2, label-1]
    (reference data/coco.py:19-49)."""

    def __init__(self, dataset: DatasetConfig):
        lm = dataset.label_map_dict
        if lm is None:
            lm = {x + 1: x + 1 for x in range(len(dataset.class_names))}
        self.label_map = lm

    def __call__(self, target: Sequence[dict], width: int, height: int):
        scale = np.array([width, height, width, height], np.float64)
        res = []
        for obj in target:
            if 'bbox' not in obj:
                continue
            bbox = obj['bbox']
            label_idx = obj['category_id']
            if label_idx >= 0:
                label_idx = self.label_map[label_idx] - 1
            box = np.array([bbox[0], bbox[1], bbox[0] + bbox[2],
                            bbox[1] + bbox[3]]) / scale
            res.append(list(box) + [label_idx])
        return res


class COCODetection:
    """Map-style dataset: ``__getitem__`` -> (img, (target, masks, num_crowds)).

    img is HWC float32 (already transformed), target is [n, 5]
    (normalized point-form box + 0-based label, crowds at the tail with
    label -1), masks is [n, H, W] float32.
    """

    def __init__(self, image_path: str, info_file: str, transform=None,
                 target_transform=None, dataset_name='MS COCO',
                 has_gt: bool = True,
                 dataset_cfg: Optional[DatasetConfig] = None):
        self.root = image_path
        self.coco = COCOIndex(info_file)
        self.ids = list(self.coco.img_to_anns.keys())
        if len(self.ids) == 0 or not has_gt:
            self.ids = list(self.coco.imgs.keys())
        self.transform = transform
        self.target_transform = target_transform or COCOAnnotationTransform(
            dataset_cfg or DatasetConfig())
        self.name = dataset_name
        self.has_gt = has_gt

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index):
        im, gt, masks, h, w, num_crowds = self.pull_item(index)
        return im, (gt, masks, num_crowds)

    def _load_image(self, img_id: int) -> np.ndarray:
        import cv2
        file_name = self.coco.imgs[img_id]['file_name']
        if file_name.startswith('COCO'):
            file_name = file_name.split('_')[-1]
        path = osp.join(self.root, file_name)
        assert osp.exists(path), f'Image path does not exist: {path}'
        return cv2.imread(path)

    def pull_item(self, index: int):
        img_id = self.ids[index]
        target = list(self.coco.img_to_anns.get(img_id, [])) if self.has_gt else []

        crowd = [x for x in target if x.get('iscrowd')]
        target = [x for x in target if not x.get('iscrowd')]
        num_crowds = len(crowd)
        crowd = [dict(x, category_id=-1) for x in crowd]
        target = target + crowd

        img = self._load_image(img_id)
        height, width, _ = img.shape

        masks = None
        if len(target) > 0:
            masks = np.stack([
                self.coco.ann_to_mask(obj, height, width).astype(np.float32)
                for obj in target])
            target = self.target_transform(target, width, height)

        if self.transform is not None:
            if len(target) > 0:
                target = np.array(target)
                img, masks, boxes, labels = self.transform(
                    img, masks, target[:, :4],
                    {'num_crowds': num_crowds, 'labels': target[:, 4]})
                num_crowds = labels['num_crowds']
                labels = labels['labels']
                target = np.hstack((boxes, np.expand_dims(labels, axis=1)))
            else:
                img, _, _, _ = self.transform(
                    img, np.zeros((1, height, width), np.float32),
                    np.array([[0., 0., 1., 1.]]),
                    {'num_crowds': 0, 'labels': np.array([0.])})
                masks = None
                target = None

        if target is not None and len(target) == 0:
            # augmentation dropped every gt: resample (data/coco.py:172-174)
            return self.pull_item(_random.randint(0, len(self.ids) - 1))

        return img, target, masks, height, width, num_crowds

    def pull_image(self, index: int) -> np.ndarray:
        return self._load_image(self.ids[index])

    def pull_anno(self, index: int):
        return self.coco.img_to_anns.get(self.ids[index], [])
