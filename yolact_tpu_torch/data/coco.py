"""COCO detection dataset, pycocotools-free: the eval side of
``yolact_tpu/data/coco.py`` (``COCOIndex``, ``COCOAnnotationTransform``,
``COCODetection``), copied for the port, and the batch contract of the
train step: ``detection_collate``, ``pad_batch`` and ``enforce_size``.
``pad_batch``'s ``multires`` targets come back unpacked (``gt_masks_proto``,
``gt_masks_seg``, which ``train/loss.py:multibox_loss`` takes by that name):
the JAX package bit-packs them to cut its host-to-TPU transfer, which is
ported only if a run on the card shows the loader starving it.

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


def detection_collate(batch):
    """Ragged collate (reference data/coco.py:260-284): lists, not stacks."""
    imgs, targets, masks, num_crowds = [], [], [], []
    for sample in batch:
        imgs.append(sample[0])
        targets.append(np.asarray(sample[1][0], np.float32))
        masks.append(np.asarray(sample[1][1], np.float32))
        num_crowds.append(sample[1][2])
    return imgs, (targets, masks, num_crowds)


def _resize_bilinear(masks: np.ndarray, size) -> np.ndarray:
    """[n, h, w] float32 -> [n, size[0], size[1]]: torch's bilinear
    downsample without antialiasing (``F.interpolate``,
    ``align_corners=False``), the reference's."""
    import torch
    import torch.nn.functional as F
    if tuple(masks.shape[-2:]) == tuple(size):
        return np.asarray(masks, np.float32)
    t = torch.from_numpy(np.ascontiguousarray(masks, np.float32))[None]
    return F.interpolate(t, size=tuple(size), mode='bilinear',
                         align_corners=False)[0].numpy()


def pad_batch(imgs, targets, masks, num_crowds, max_gt: int = 100,
              multires=None):
    """Fixed-shape batch: pads or truncates gt to `max_gt` per image.

    Returns a dict of numpy arrays:
      image      [B, S, S, 3] float32
      gt_boxes   [B, max_gt, 4]   (zeros padding)
      gt_labels  [B, max_gt] int32  (-1 label marks crowds, -2 marks padding)
      gt_masks   [B, max_gt, S, S] uint8
      num_gts    [B] int32  (valid incl. crowds)
      num_crowds [B] int32
    Truncation drops crowd annotations first, then the highest-index
    (latest in annotation order) gts, NOT by area: reordering gts would
    change the matcher's tie-breaks.

    ``multires``: optional ``{'proto': (Hp, Wp), 'seg': (Hs, Ws) | None}``.
    When given, the full-res ``gt_masks`` are REPLACED by pre-downsampled
    uint8 targets ``gt_masks_proto`` (and ``gt_masks_seg``), computed in the
    reference's order of operations: torch-bilinear downsample of the SOFT
    augmented mask, THEN binarize at 0.5 (multibox_loss.py:515-523,
    225-228).  Only valid for lincomb configs with
    mask_proto_binarize_downsampled_gt.
    """
    B = len(imgs)
    S = imgs[0].shape[0]
    out_img = np.stack(imgs).astype(np.float32)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    labels = np.full((B, max_gt), -2, np.int32)
    out_masks = None if multires else \
        np.zeros((B, max_gt, S, S), np.uint8)
    if multires:
        proto = np.zeros((B, max_gt) + tuple(multires['proto']), np.uint8)
        seg_hw = multires.get('seg')
        seg = None if seg_hw is None else \
            np.zeros((B, max_gt) + tuple(seg_hw), np.uint8)
    n_gts = np.zeros(B, np.int32)
    n_crowds = np.zeros(B, np.int32)

    for i in range(B):
        t = np.asarray(targets[i], np.float32)
        m = np.asarray(masks[i])
        nc = int(num_crowds[i])
        n = len(t)
        if n > max_gt:
            # keep all non-crowds up to max_gt; drop crowds, then largest idx
            n_keep_crowds = max(0, max_gt - (n - nc))
            drop = nc - n_keep_crowds
            if drop > 0:
                t = t[:n - drop]
                m = m[:n - drop]
                nc = n_keep_crowds
            if len(t) > max_gt:
                t = t[:max_gt]
                m = m[:max_gt]
            n = len(t)
        boxes[i, :n] = t[:, :4]
        labels[i, :n] = t[:, 4].astype(np.int32)
        if multires:
            if n:
                soft = np.asarray(m[:n], np.float32)
                proto[i, :n] = _resize_bilinear(soft, multires['proto']) > 0.5
                if seg is not None:
                    seg[i, :n] = _resize_bilinear(soft, seg_hw) > 0.5
        else:
            out_masks[i, :n] = (m > 0.5).astype(np.uint8)
        n_gts[i] = n
        n_crowds[i] = nc

    out = dict(image=out_img, gt_boxes=boxes, gt_labels=labels,
               num_gts=n_gts, num_crowds=n_crowds)
    if multires:
        out['gt_masks_proto'] = proto
        if seg is not None:
            out['gt_masks_seg'] = seg
    else:
        out['gt_masks'] = out_masks
    return out


def enforce_size(img, targets, masks, num_crowds, new_w, new_h):
    """Resize (aspect-preserving) + zero-pad an image/gt tuple to exactly
    (new_h, new_w): host-side util for batching preserve_aspect_ratio
    inputs (reference data/coco.py:219-255).

    img: [h, w, 3] float; masks: [n, h, w]; targets: [n, 5] normalized.
    The resize is ``data/augmentations.py:resize_linear``, cv2's
    INTER_LINEAR order in numpy.
    """
    from yolact_tpu_torch.data.augmentations import resize_linear
    h, w = img.shape[:2]
    if h == new_h and w == new_w:
        return img, targets, masks, num_crowds

    w_prime = new_w
    h_prime = h * new_w / w
    if h_prime > new_h:
        w_prime *= new_h / h_prime
        h_prime = new_h
    w_prime, h_prime = int(w_prime), int(h_prime)

    img = resize_linear(img, w_prime, h_prime)
    if masks is not None and len(masks):
        masks = resize_linear(masks, w_prime, h_prime, axis=1)

    if targets is not None and len(targets):
        targets = targets.copy()
        targets[:, [0, 2]] *= (w_prime / new_w)
        targets[:, [1, 3]] *= (h_prime / new_h)

    out = np.zeros((new_h, new_w) + img.shape[2:], img.dtype)
    out[:h_prime, :w_prime] = img
    if masks is not None and len(masks):
        mp = np.zeros((masks.shape[0], new_h, new_w), masks.dtype)
        mp[:, :h_prime, :w_prime] = masks
        masks = mp
    return out, targets, masks, num_crowds
