"""Evaluation / inference CLI of the port: the flags of
``yolact_tpu/cli/eval.py`` (the reference's ``eval.py:40-128``).

python -m yolact_tpu_torch.cli.eval --trained_model=weights/yolact_base_54_800000.pth
python -m yolact_tpu_torch.cli.eval --trained_model=... --output_coco_json
python -m yolact_tpu_torch.cli.eval --trained_model=... --image=in.jpg:out.png

Weights are reference ``.pth`` state dicts (``train/checkpoint.py``).  The
model runs on ``cuda:0`` (``--cuda=False``: on the CPU, with the kernels'
plain PyTorch versions); a CUDA request without a card raises.  Raw frames
through the fast-NMS pipeline (``--image``, ``--images``) take the
space-to-depth stem kernel where the config supports it, as JAX's
``Pipeline`` does; otherwise the stem is the plain 7x7/s2 conv unless
``--stem_s2d`` asks for the s2d one.  ``--video`` and ``--eval_devices``
other than 1 are not ported yet (ROADMAP A9).  cv2 is imported only where
images are read, drawn or written.
"""

from __future__ import annotations

import argparse
import os
import random


def str2bool(v):
    if isinstance(v, bool):
        return v
    return v.lower() in ('yes', 'true', 't', '1')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='YOLACT evaluation (PyTorch port)')
    p.add_argument('--trained_model', default='weights/yolact_base_54_800000.pth',
                   type=str)
    p.add_argument('--top_k', default=5, type=int)
    p.add_argument('--cuda', default=True, type=str2bool,
                   help='run on cuda:0 (False: on the CPU)')
    p.add_argument('--fast_nms', default=True, type=str2bool)
    p.add_argument('--cross_class_nms', default=False, type=str2bool)
    p.add_argument('--display_masks', default=True, type=str2bool)
    p.add_argument('--display_bboxes', default=True, type=str2bool)
    p.add_argument('--display_text', default=True, type=str2bool)
    p.add_argument('--display_scores', default=True, type=str2bool)
    p.add_argument('--display', dest='display', action='store_true')
    p.add_argument('--shuffle', dest='shuffle', action='store_true')
    p.add_argument('--ap_data_file', default='results/ap_data.pkl', type=str)
    p.add_argument('--resume', dest='resume', action='store_true',
                   help='resume mAP from ap_data_file')
    p.add_argument('--max_images', default=-1, type=int)
    p.add_argument('--output_coco_json', dest='output_coco_json',
                   action='store_true')
    p.add_argument('--bbox_det_file', default='results/bbox_detections.json',
                   type=str)
    p.add_argument('--mask_det_file', default='results/mask_detections.json',
                   type=str)
    p.add_argument('--config', default=None)
    p.add_argument('--output_web_json', dest='output_web_json',
                   action='store_true')
    p.add_argument('--web_det_path', default='web/dets/', type=str)
    p.add_argument('--no_bar', dest='no_bar', action='store_true')
    p.add_argument('--display_lincomb', default=False, type=str2bool)
    p.add_argument('--benchmark', default=False, dest='benchmark',
                   action='store_true')
    p.add_argument('--no_sort', default=False, dest='no_sort',
                   action='store_true')
    p.add_argument('--seed', default=None, type=int)
    p.add_argument('--mask_proto_debug', default=False, dest='mask_proto_debug',
                   action='store_true')
    p.add_argument('--no_crop', dest='crop', action='store_false')
    p.add_argument('--image', default=None, type=str)
    p.add_argument('--images', default=None, type=str)
    p.add_argument('--video', default=None, type=str)
    p.add_argument('--video_multiframe', default=1, type=int)
    p.add_argument('--score_threshold', default=0, type=float)
    p.add_argument('--eval_batch_size', default=1, type=int,
                   help='device batch for dataset evaluation (no reference '
                        'equivalent)')
    p.add_argument('--eval_devices', default=1, type=int,
                   help='devices to shard each eval batch over; only 1 is '
                        'ported')
    p.add_argument('--dataset', default=None, type=str)
    p.add_argument('--detect', default=False, dest='detect',
                   action='store_true',
                   help='run as a detector only (no mask branch eval)')
    p.add_argument('--display_fps', default=False, dest='display_fps',
                   action='store_true')
    p.add_argument('--emulate_playback', default=False,
                   dest='emulate_playback', action='store_true')
    p.add_argument('--stem_s2d', default=False, dest='stem_s2d',
                   action='store_true',
                   help='space-to-depth stem (the stem kernel); the same '
                        'math as the plain 7x7/s2 stem on the same weights')
    p.set_defaults(no_bar=False, display=False, resume=False, detect=False,
                   display_fps=False, emulate_playback=False, crop=True)
    return p.parse_args(argv)


def load_model(args):
    """(cfg, state dict, device) from the flags."""
    from yolact_tpu_torch.config import (config_from_model_path, get_config,
                                   get_dataset)
    from yolact_tpu_torch.infer import check_device
    from yolact_tpu_torch.train.checkpoint import load_weights

    if args.config is None:
        cfg = config_from_model_path(args.trained_model)
        print(f'Config not specified. Parsed {cfg.name}_config from the '
              f'file name.\n')
    else:
        cfg = get_config(args.config)
    if args.dataset is not None:
        cfg = cfg.copy(dataset=get_dataset(args.dataset))
    if args.detect:
        cfg = cfg.copy(eval_mask_branch=False)
    if args.stem_s2d:
        cfg = cfg.copy(stem_s2d=True)
    device = check_device('cuda:0' if args.cuda else 'cpu')
    return cfg, load_weights(cfg, args.trained_model), device


def make_image_pipeline(cfg, state_dict, device, args):
    """One pipeline on raw frames, reused across the images of --images."""
    if args.fast_nms:
        from yolact_tpu_torch.infer import Pipeline
        return Pipeline(cfg, state_dict, device,
                        use_cross_class_nms=args.cross_class_nms,
                        score_threshold=args.score_threshold,
                        crop_masks=args.crop, preprocess=True)
    # host greedy per-class NMS (the reference's --fast_nms=False)
    from yolact_tpu_torch.eval.traditional import TraditionalPipeline
    return TraditionalPipeline(cfg, state_dict, device,
                               score_threshold=args.score_threshold,
                               preprocess=True, crop_masks=args.crop)


def evalimage(cfg, args, pipeline, path: str, save_path=None):
    """Single-image inference (eval.py:595-610)."""
    import cv2
    import numpy as np
    import torch
    from yolact_tpu_torch.eval.display import draw_detections
    from yolact_tpu_torch.detect.postprocess import finish_masks
    from yolact_tpu_torch.eval.evaluate import sanitize_boxes_np

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f'cannot read image {path}')
    h, w = img.shape[:2]
    frame = img.astype(np.float32)[None]
    out = pipeline(frame)

    if args.display_lincomb:
        # prototype-combination debug view (output_utils.py:147-189)
        from yolact_tpu_torch.eval.display import display_lincomb
        from yolact_tpu_torch.detect.detection import detect
        from yolact_tpu_torch.infer import _prepare_input
        # the pipeline's config: its stem may be the s2d one
        with torch.inference_mode():
            x = _prepare_input(pipeline.cfg,
                               torch.as_tensor(frame, device=pipeline.device),
                               preprocess=True)
            d = detect(pipeline.cfg, pipeline.model(x))
        display_lincomb(d.proto[0].cpu().numpy(), d.masks[0].cpu().numpy(),
                        out_path=os.path.splitext(path)[0] + '_lincomb.png')
    n = int(out.valid[0].sum())
    # the reference's prep_display forces rescore_bbox=True during display
    # (eval.py:147-149), so plus configs show maskiou-rescored scores
    scores = out.scores[0, :n]
    if out.mask_scores is not None and cfg.rescore_mask:
        scores = out.mask_scores[0, :n]
    boxes_abs = sanitize_boxes_np(out.boxes[0, :n].cpu().numpy(), w, h)
    masks = finish_masks(out.masks[0, :n], w, h)
    drawn = draw_detections(
        cfg, img, out.classes[0, :n].cpu().numpy(), scores.cpu().numpy(),
        boxes_abs, masks,
        top_k=args.top_k, score_threshold=args.score_threshold,
        display_masks=args.display_masks, display_bboxes=args.display_bboxes,
        display_text=args.display_text, display_scores=args.display_scores)
    if save_path is None:
        save_path = os.path.splitext(path)[0] + '_out.png'
    cv2.imwrite(save_path, drawn)
    print(f'Saved to {save_path}')


def evalimages(cfg, state_dict, device, args, inp: str, out: str):
    os.makedirs(out, exist_ok=True)
    pipeline = make_image_pipeline(cfg, state_dict, device, args)
    for name in sorted(os.listdir(inp)):
        path = os.path.join(inp, name)
        save = os.path.join(out, os.path.splitext(name)[0] + '.png')
        evalimage(cfg, args, pipeline, path, save)
    print('Done.')


def main(argv=None):
    args = parse_args(argv)
    if args.video is not None:
        raise NotImplementedError('--video is not ported yet (ROADMAP A9)')
    if args.eval_devices != 1:
        raise NotImplementedError(
            f'--eval_devices={args.eval_devices}: multi-device evaluation is '
            f'not ported yet (ROADMAP A9)')
    if args.seed is not None:
        random.seed(args.seed)

    cfg, state_dict, device = load_model(args)
    print('Model loaded.\n')

    if args.image is not None:
        pipeline = make_image_pipeline(cfg, state_dict, device, args)
        if ':' in args.image:
            inp, out = args.image.split(':')
            evalimage(cfg, args, pipeline, inp, out)
        else:
            evalimage(cfg, args, pipeline, args.image)
        return
    if args.images is not None:
        inp, out = args.images.split(':')
        evalimages(cfg, state_dict, device, args, inp, out)
        return

    from yolact_tpu_torch.eval.evaluate import (calc_map_from_file,
                                                evaluate_dataset,
                                                make_eval_dataset)
    if args.resume:
        calc_map_from_file(cfg, args.ap_data_file)
        return
    evaluate_dataset(
        cfg, state_dict, make_eval_dataset(cfg), device,
        eval_batch_size=args.eval_batch_size,
        max_images=args.max_images, fast_nms=args.fast_nms,
        cross_class_nms=args.cross_class_nms,
        score_threshold=args.score_threshold, crop_masks=args.crop,
        shuffle=args.shuffle, no_sort=args.no_sort,
        output_coco_json=args.output_coco_json,
        bbox_det_file=args.bbox_det_file, mask_det_file=args.mask_det_file,
        output_web_json=args.output_web_json, web_det_path=args.web_det_path,
        benchmark=args.benchmark, mask_proto_debug=args.mask_proto_debug,
        ap_data_file=args.ap_data_file, display=args.display,
        top_k=args.top_k, no_bar=args.no_bar)


if __name__ == '__main__':
    main()
