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
timer).  The mask upsample to image size runs on the device.  For the mAP
table on a CUDA device the mask IoU runs there too
(``eval/device_metrics.py``, ``device_mask_iou``): each image's gt masks
go to the card and only the ``[D, G]`` IoU matrices come back.  Otherwise
(the CPU, ``--output_coco_json``, ``--display``) the ``[D, h, w]`` masks
come to the host (``detect/postprocess.py:finish_masks``) and the
evaluator computes the IoU there.  Direct masks (``MaskType.DIRECT``) are
box-local patches: they always take the host paste
(``finish_masks_direct``), on the card too, as in JAX.

Multi-device evaluation (``n_devices``; JAX shards each batch over a 1-D
device mesh): one pipeline replica per device (:class:`ReplicatedPipeline`)
takes its equal slice of each batch in order, and the outputs are merged
in order on the first device, so the loop after it is the one-device
loop.  The batch is rounded up to a multiple of the device count (and the
rounding printed), 0 means every local device, and a request for more
devices than are present raises, as in JAX.  On the CPU every replica
runs on the CPU.
"""

from __future__ import annotations

import os
import pickle
import queue
import random as _random
import threading
import time
import traceback
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from yolact_tpu_torch.config import MaskType, YolactConfig
from yolact_tpu_torch.data.coco import COCODetection
from yolact_tpu_torch.detect.postprocess import (finish_masks,
                                                 finish_masks_direct)
from yolact_tpu_torch.eval.coco_json import DetectionsWriter
from yolact_tpu_torch.eval.device_metrics import mask_iou_device
from yolact_tpu_torch.eval.evaluator import (badhash, calc_map,
                                             make_ap_data, prep_metrics)
from yolact_tpu_torch.eval.traditional import TraditionalPipeline
from yolact_tpu_torch.infer import (InferenceOutput, Pipeline, _prepare_input,
                                    check_device)
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


class ReplicatedPipeline:
    """Pipeline replicas, one per device, behind one pipeline's call: each
    batch is cut into equal slices in order, replica ``i`` answers slice
    ``i``, and the outputs are concatenated in order on the first
    replica's device.  ``model`` is the first replica's."""

    def __init__(self, replicas: List):
        self.replicas = replicas
        self.device = replicas[0].device

    @property
    def model(self):
        return self.replicas[0].model

    def __call__(self, images) -> InferenceOutput:
        n = len(images) // len(self.replicas)
        if n * len(self.replicas) != len(images):
            raise ValueError(f'a batch of {len(images)} does not divide '
                             f'over {len(self.replicas)} devices')
        outs = [r(images[i * n:(i + 1) * n])
                for i, r in enumerate(self.replicas)]
        return InferenceOutput(*(
            None if getattr(outs[0], f) is None
            else torch.cat([getattr(o, f).to(self.device) for o in outs])
            for f in InferenceOutput._fields))


def eval_devices(device: Union[str, torch.device], n_devices: int
                 ) -> List[torch.device]:
    """The devices of `n_devices` replicas (0: every local device): CUDA
    devices 0 .. n - 1 for a CUDA `device` (more than are present raises),
    `device` itself n times for the CPU."""
    device = check_device(device)
    if device.type != 'cuda':
        return [device] * max(1, n_devices)
    present = torch.cuda.device_count()
    n = present if n_devices == 0 else n_devices
    if n > present:
        raise ValueError(f'--eval_devices={n} but only {present} CUDA '
                         f'devices are present')
    if n == 1:
        return [device]
    return [torch.device('cuda', i) for i in range(n)]


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
    host-transformed images (``make_eval_dataset``).  ``device_mask_iou``
    computes the mask IoU of the mAP table on the pipeline's device
    (default: when that device is CUDA); the JSON and display modes need
    the masks on the host and do not take it.  ``n_devices``: replicas on
    that many devices, 0 for every local one (module docstring)."""
    devices = eval_devices(device, n_devices)
    if len(devices) > 1 and eval_batch_size % len(devices):
        rounded = -(-eval_batch_size // len(devices)) * len(devices)
        if not quiet:
            print(f'eval_batch_size {eval_batch_size} not divisible by '
                  f'{len(devices)} devices; using {rounded}')
        eval_batch_size = rounded

    def replica(dev):
        if fast_nms:
            return Pipeline(cfg, state_dict, dev, compute_dtype,
                            use_cross_class_nms=cross_class_nms,
                            score_threshold=score_threshold,
                            crop_masks=crop_masks, use_kernels=use_kernels,
                            preprocess=False)
        # traditional greedy NMS: the card runs forward + decode + scores,
        # the per-class O(n^2) suppression and mask assembly run on the
        # host (detection.py:182-228 semantics)
        return TraditionalPipeline(cfg, state_dict, dev, compute_dtype,
                                   score_threshold=score_threshold,
                                   preprocess=False, crop_masks=crop_masks,
                                   use_kernels=use_kernels)

    pipeline = replica(devices[0]) if len(devices) == 1 else \
        ReplicatedPipeline([replica(d) for d in devices])

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
    if device_mask_iou is None:
        device_mask_iou = pipeline.device.type == 'cuda'
    # the device IoU upsamples canvas-global proto-resolution masks; direct
    # masks are box-local patches and take the host paste
    use_dev_miou = (device_mask_iou and compute_map and not display
                    and cfg.mask_type == MaskType.LINCOMB)
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

                miou_full = crowd_full = masks_full = None
                with timer.env('Postprocess'):
                    boxes_abs = sanitize_boxes_np(boxes_rel, w, h)
                    if use_dev_miou and gt is not None:
                        miou, crowd, _ = mask_iou_device(
                            out.masks[bi, :n], np.asarray(gt_masks), h, w)
                        miou_full = miou.cpu().numpy()
                        crowd_full = crowd.cpu().numpy()
                    elif cfg.mask_type == MaskType.DIRECT:
                        masks_full = finish_masks_direct(
                            out.masks[bi, :n], boxes_abs, w, h)
                    elif not use_dev_miou:
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
                                     None if miou_full is not None
                                     else np.asarray(gt_masks), num_crowd,
                                     mask_iou_full=miou_full,
                                     crowd_mask_iou_full=crowd_full)

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
    from yolact_tpu_torch.data.augmentations import BaseTransform
    return COCODetection(cfg.dataset.valid_images, cfg.dataset.valid_info,
                         transform=BaseTransform(cfg),
                         dataset_cfg=cfg.dataset,
                         has_gt=cfg.dataset.has_gt)
