"""Quantitative COCO evaluation loop.  Port of
``yolact_tpu/eval/evaluate.py`` (``evaluate_dataset``, ``calc_map_from_file``,
``make_eval_dataset``).

The loop is the JAX package's: the badhash image order, a host thread that
prefetches and transforms images, fixed-size device batches
(``eval_batch_size``, the last one padded with copies of its last image)
through one pipeline (fast NMS on the card, or the traditional host NMS),
then per image the greedy AP matching into ``APDataObject``s and the final
``calc_map`` table, or COCO / web JSON, or ``--benchmark`` timings.  The
host-side pieces are the port's copies of the JAX package's (the
evaluator, the JSON writer, the COCO dataset, the progress bar and the
timer).  The mask upsample to image size runs on the device
(``detect/postprocess.py:finish_masks``); mask IoU runs on the host.
``eval/device_metrics.py`` and multi-device evaluation are not ported yet
(ROADMAP A5, A9).
"""

from __future__ import annotations

import os
import pickle
import queue
import random as _random
import threading
import time
import traceback
from typing import Dict, Optional, Union

import numpy as np
import torch

from yolact_tpu_torch.config import YolactConfig
from yolact_tpu_torch.data.coco import COCODetection
from yolact_tpu_torch.detect.postprocess import finish_masks
from yolact_tpu_torch.eval.coco_json import DetectionsWriter
from yolact_tpu_torch.eval.evaluator import (badhash, calc_map,
                                             make_ap_data, prep_metrics)
from yolact_tpu_torch.eval.traditional import TraditionalPipeline
from yolact_tpu_torch.infer import Pipeline, _prepare_input
from yolact_tpu_torch.utils import timer
from yolact_tpu_torch.utils.functions import MovingAverage, ProgressBar


def sanitize_boxes_np(boxes: np.ndarray, w: int, h: int) -> np.ndarray:
    """Relative point-form -> absolute int boxes (output_utils.py:97-99)."""
    x1 = np.minimum(boxes[:, 0], boxes[:, 2]) * w
    x2 = np.maximum(boxes[:, 0], boxes[:, 2]) * w
    y1 = np.minimum(boxes[:, 1], boxes[:, 3]) * h
    y2 = np.maximum(boxes[:, 1], boxes[:, 3]) * h
    out = np.stack([np.clip(x1, 0, w), np.clip(y1, 0, h),
                    np.clip(x2, 0, w), np.clip(y2, 0, h)], axis=1)
    return out.astype(np.int64)


class _PrefetchError:
    """Sentinel carrying a prefetcher exception to the consumer."""

    def __init__(self, exc):
        self.exc = exc
        self.tb = traceback.format_exc()


def _prefetcher(dataset, indices, out_q, stop):
    """Stop-aware prefetch: bounded puts use a timeout so a dying consumer
    (stop set in its finally) can't strand this thread on a full queue,
    and any pull_item exception is forwarded instead of silently killing
    the thread (which would hang the consumer's blocking get forever)."""

    def put(x):
        while not stop.is_set():
            try:
                out_q.put(x, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    try:
        for idx in indices:
            if stop.is_set():
                return
            item = dataset.pull_item(idx)
            if not put((idx, item)):
                return
    except BaseException as e:
        put(_PrefetchError(e))
        return
    put(None)


def evaluate_dataset(cfg: YolactConfig, state_dict: Dict[str, torch.Tensor],
                     dataset: COCODetection,
                     device: Union[str, torch.device] = 'cuda',
                     compute_dtype: Optional[str] = None,
                     max_images: int = -1,
                     eval_batch_size: int = 1,
                     fast_nms: bool = True,
                     cross_class_nms: bool = False,
                     score_threshold: float = 0.0,
                     crop_masks: bool = True,
                     shuffle: bool = False,
                     no_sort: bool = False,
                     output_coco_json: bool = False,
                     bbox_det_file: str = 'results/bbox_detections.json',
                     mask_det_file: str = 'results/mask_detections.json',
                     output_web_json: bool = False,
                     web_det_path: str = 'web/dets/',
                     benchmark: bool = False,
                     mask_proto_debug: bool = False,
                     ap_data_file: Optional[str] = None,
                     display: bool = False,
                     display_dir: str = 'displays/',
                     top_k: int = 15,
                     device_mask_iou: Optional[bool] = None,
                     quiet: bool = False,
                     no_bar: bool = False,
                     n_devices: int = 1,
                     use_kernels: bool = True) -> Optional[Dict]:
    """Returns the all_maps dict (or None for json/benchmark modes).

    ``state_dict`` holds the port's weights (the mask scorer's included,
    for YOLACT++ configs); the model runs on ``device`` in
    ``compute_dtype`` (default ``cfg.compute_dtype``).  ``dataset`` gives
    host-transformed images (``make_eval_dataset``)."""
    if n_devices != 1:
        raise NotImplementedError(
            'multi-device evaluation is not ported yet (ROADMAP A9)')
    if device_mask_iou:
        raise NotImplementedError(
            'device mask IoU (eval/device_metrics.py) is not ported yet '
            '(ROADMAP A5); the host path computes the same metrics')
    if fast_nms:
        pipeline = Pipeline(cfg, state_dict, device, compute_dtype,
                            use_cross_class_nms=cross_class_nms,
                            score_threshold=score_threshold,
                            crop_masks=crop_masks, use_kernels=use_kernels,
                            preprocess=False)
    else:
        # traditional greedy NMS: the card runs forward + decode + scores,
        # the per-class O(n^2) suppression and mask assembly run on the
        # host (detection.py:182-228 semantics)
        pipeline = TraditionalPipeline(cfg, state_dict, device, compute_dtype,
                                       score_threshold=score_threshold,
                                       preprocess=False,
                                       crop_masks=crop_masks,
                                       use_kernels=use_kernels)

    dataset_size = len(dataset) if max_images < 0 else \
        min(max_images, len(dataset))
    progress_bar = ProgressBar(30, dataset_size)
    frame_times = MovingAverage()

    dataset_indices = list(range(len(dataset)))
    if shuffle:
        _random.shuffle(dataset_indices)
    elif not no_sort:
        hashed = [badhash(x) for x in dataset.ids]
        dataset_indices.sort(key=lambda x: hashed[x])
    dataset_indices = dataset_indices[:dataset_size]

    compute_map = not output_coco_json and not benchmark
    ap_data = make_ap_data(len(cfg.dataset.class_names))
    detections = DetectionsWriter(cfg)

    item_q: "queue.Queue" = queue.Queue(maxsize=2 * eval_batch_size + 2)
    stop = threading.Event()
    threading.Thread(target=_prefetcher,
                     args=(dataset, dataset_indices, item_q, stop),
                     daemon=True).start()

    done = 0
    pending = []  # (image_idx, item)
    exhausted = False
    t_last = time.perf_counter()
    try:
        while done < dataset_size:
            while len(pending) < eval_batch_size and not exhausted:
                got = item_q.get()
                if got is None:
                    exhausted = True
                    break
                if isinstance(got, _PrefetchError):
                    raise RuntimeError(
                        f'eval prefetch failed:\n{got.tb}') from got.exc
                pending.append(got)
            if not pending:
                break
            batch_items = pending[:eval_batch_size]
            pending = pending[len(batch_items):]
            n_real = len(batch_items)

            with timer.env('Network'):
                imgs = np.stack([np.asarray(it[1][0]) for it in batch_items])
                if n_real < eval_batch_size:
                    imgs = np.concatenate(
                        [imgs, np.repeat(imgs[-1:],
                                         eval_batch_size - n_real, 0)])
                out = pipeline(imgs)
                # the small outputs come to the host once per batch
                valid_all, classes_all, scores_all, boxes_all = (
                    t.cpu().numpy() for t in (out.valid, out.classes,
                                              out.scores, out.boxes))
                mask_scores_all = None if out.mask_scores is None \
                    else out.mask_scores.cpu().numpy()

            if mask_proto_debug and done == 0:
                os.makedirs('scripts', exist_ok=True)
                with torch.inference_mode():
                    x = _prepare_input(
                        cfg, torch.as_tensor(imgs[:1], device=pipeline.device),
                        preprocess=False)
                    preds = pipeline.model(x, use_kernels=use_kernels)
                np.save('scripts/proto.npy', preds['proto'][0].cpu().numpy())
                if batch_items[0][1][2] is not None:
                    np.save('scripts/gt.npy',
                            np.asarray(batch_items[0][1][2]))

            for bi, (image_idx, item) in enumerate(batch_items):
                img, gt, gt_masks, h, w, num_crowd = item
                now = time.perf_counter()
                if done > 1:
                    # skip the first two frames like the reference
                    # (eval.py:963-965): the first batch pays the kernel
                    # build and the card's warm-up
                    frame_times.add(now - t_last)
                t_last = now
                done += 1
                if benchmark:
                    continue

                n = int(valid_all[bi].sum())
                classes = classes_all[bi, :n]
                box_scores = scores_all[bi, :n]
                if mask_scores_all is not None and cfg.rescore_mask:
                    mask_scores = mask_scores_all[bi, :n]
                    if cfg.rescore_bbox:
                        box_scores = mask_scores
                else:
                    mask_scores = box_scores
                boxes_rel = boxes_all[bi, :n]

                with timer.env('Postprocess'):
                    boxes_abs = sanitize_boxes_np(boxes_rel, w, h)
                    masks_full = finish_masks(out.masks[bi, :n], w, h)
                # NOTE: cfg.discard_mask_area is TRAINING-only in the
                # reference (maskiou gt filter, multibox_loss.py:630-632);
                # eval never drops detections by mask area

                if display:
                    # headless display mode: render detections over the
                    # original image to display_dir (the reference pops a
                    # matplotlib window, eval.py:945-961)
                    import cv2
                    from yolact_tpu_torch.eval.display import draw_detections
                    os.makedirs(display_dir, exist_ok=True)
                    raw = dataset.pull_image(image_idx)
                    # prep_display forces rescore_bbox=True (eval.py:147-149)
                    disp_scores = mask_scores if cfg.rescore_mask \
                        else box_scores
                    drawn = draw_detections(
                        cfg, raw, classes, disp_scores, boxes_abs, masks_full,
                        top_k=top_k, score_threshold=score_threshold)
                    cv2.imwrite(os.path.join(
                        display_dir, f'{dataset.ids[image_idx]}.png'), drawn)

                if output_coco_json:
                    with timer.env('JSON Output'):
                        image_id = dataset.ids[image_idx]
                        for i in range(n):
                            if (boxes_abs[i, 3] - boxes_abs[i, 1]) * \
                                    (boxes_abs[i, 2] - boxes_abs[i, 0]) > 0:
                                detections.add_bbox(image_id, classes[i],
                                                    boxes_abs[i],
                                                    box_scores[i])
                                detections.add_mask(image_id, classes[i],
                                                    masks_full[i],
                                                    mask_scores[i])
                elif compute_map and gt is not None:
                    gt = np.asarray(gt)
                    gt_boxes = gt[:, :4].copy()
                    gt_boxes[:, [0, 2]] *= w
                    gt_boxes[:, [1, 3]] *= h
                    with timer.env('Main loop'):
                        prep_metrics(ap_data, classes, box_scores,
                                     mask_scores, boxes_abs, masks_full,
                                     gt_boxes, gt[:, 4].astype(int),
                                     np.asarray(gt_masks), num_crowd)

                if not quiet and not no_bar:
                    fps = 1 / frame_times.get_avg() if len(frame_times) \
                        else 0
                    progress_bar.set_val(done)
                    print(f'\rProcessing Images  {progress_bar} '
                          f'{done:6d} / {dataset_size:6d} '
                          f'({done * 100 / dataset_size:5.2f}%) '
                          f'{fps:7.2f} fps ', end='')
    finally:
        stop.set()

    if not quiet and not no_bar:
        print()

    if benchmark:
        print()
        print('Stats for the last frame:')
        timer.print_stats()
        avg = frame_times.get_avg() if len(frame_times) else float('nan')
        print(f'Average: {avg * 1000:5.2f} ms / frame ({1 / avg:5.2f} fps)')
        return None

    if output_coco_json:
        os.makedirs(os.path.dirname(bbox_det_file) or '.', exist_ok=True)
        detections.dump(bbox_det_file, mask_det_file)
        if output_web_json:
            detections.dump_web(web_det_path)
        return None

    if ap_data_file:
        # raw AP state dump for --resume (eval.py ap_data_file flow)
        os.makedirs(os.path.dirname(ap_data_file) or '.', exist_ok=True)
        with open(ap_data_file, 'wb') as f:
            pickle.dump(ap_data, f)

    return calc_map(ap_data, cfg.dataset.class_names, print_table=not quiet)


def calc_map_from_file(cfg: YolactConfig, ap_data_file: str) -> Dict:
    """Recompute the mAP table from a saved ap_data pickle
    (eval.py --resume)."""
    with open(ap_data_file, 'rb') as f:
        ap_data = pickle.load(f)
    return calc_map(ap_data, cfg.dataset.class_names)


def make_eval_dataset(cfg: YolactConfig) -> COCODetection:
    # BaseTransform resizes with cv2, imported only where it resizes
    from yolact_tpu_torch.data.augmentations import BaseTransform
    return COCODetection(cfg.dataset.valid_images, cfg.dataset.valid_info,
                         transform=BaseTransform(cfg),
                         dataset_cfg=cfg.dataset,
                         has_gt=cfg.dataset.has_gt)
