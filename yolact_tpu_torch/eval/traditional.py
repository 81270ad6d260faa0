"""Traditional (greedy, per-class) NMS: the model on the device, the NMS on
the host.  Port of ``yolact_tpu/eval/traditional.py:TraditionalPipeline``.

The host half is the JAX package's own and is reused as it is
(``traditional_nms``, ``host_assemble_masks`` and the native
``_greedy_nms``; that module imports only numpy and ``yolact_tpu.native``).
:func:`infer.forward_raw` runs on the card; the kept detections are
assembled into masks on the host, padded to ``max_num_detections`` and,
for YOLACT++ configs, re-scored by the mask scorer on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from yolact_tpu.config import YolactConfig
from yolact_tpu.eval.traditional import host_assemble_masks, traditional_nms
from yolact_tpu_torch.detect.postprocess import select_class_maskiou
from yolact_tpu_torch.infer import (InferenceOutput, check_device,
                                    forward_raw, load_model)


class TraditionalPipeline:
    """``infer.Pipeline``'s counterpart for ``--fast_nms=False``, with the
    same ``InferenceOutput`` contract: padded detections, proto-resolution
    cropped sigmoid masks (1x1 zeros without a mask branch) and, for
    YOLACT++ configs, ``mask_scores``.  Outputs are tensors on the
    pipeline's device."""

    def __init__(self, cfg: YolactConfig, state_dict: Dict[str, torch.Tensor],
                 device: Union[str, torch.device],
                 compute_dtype: Optional[str] = None,
                 score_threshold: float = 0.0, preprocess: bool = False,
                 crop_masks: bool = True, use_kernels: bool = True):
        self.cfg = cfg
        self.device = check_device(device)
        self.model = load_model(cfg, state_dict, self.device, compute_dtype)
        self.score_threshold = score_threshold
        self.preprocess = preprocess
        self.crop_masks = crop_masks
        self.use_kernels = use_kernels

    def __call__(self, images) -> InferenceOutput:
        cfg = self.cfg
        with torch.inference_mode():
            images = torch.as_tensor(images, device=self.device)
            raw = forward_raw(cfg, self.model, images, self.preprocess,
                              self.use_kernels)
        boxes, scores, coeffs = (t.cpu().numpy() for t in raw[:3])
        proto = raw[3].cpu().numpy() if raw[3] is not None else None
        B, D = boxes.shape[0], cfg.max_num_detections
        hp, wp = (1, 1) if proto is None else proto.shape[1:3]
        ob = np.zeros((B, D, 4), np.float32)
        oc = np.zeros((B, D), np.int32)
        os_ = np.full((B, D), -1.0, np.float32)
        om = np.zeros((B, D, hp, wp), np.float32)
        ov = np.zeros((B, D), bool)
        for b in range(B):
            bb, cc, cls, sc = traditional_nms(cfg, boxes[b], coeffs[b],
                                              scores[b])
            n = min(len(sc), D)
            ob[b, :n] = bb[:n]
            oc[b, :n] = cls[:n]
            os_[b, :n] = sc[:n]
            ov[b, :n] = sc[:n] > self.score_threshold \
                if self.score_threshold > 0 else True
            if n and proto is not None:
                om[b, :n] = host_assemble_masks(proto[b], cc[:n], bb[:n],
                                                crop=self.crop_masks)
        dev = self.device
        out = InferenceOutput(*(torch.from_numpy(a).to(dev)
                                for a in (ob, oc, os_, om, ov)))
        net = self.model.maskiou_net
        if net is not None and cfg.eval_mask_branch:
            # the reference re-scores in postprocess, after either NMS
            # (output_utils.py:79-88)
            with torch.inference_mode():
                iou_p = net(out.masks.reshape(B * D, 1, hp, wp))
                out = out._replace(mask_scores=out.scores * select_class_maskiou(
                    iou_p.reshape(B, D, -1), out.classes))
        return out
