"""Video inference on one device.  Port of ``yolact_tpu/eval/video.py``
(``PlaybackStabilizer``, ``evalvideo``; the reference's ``evalvideo``,
``eval.py:636-868``).

Three threads and two bounded queues:

  reader  ->  [video_multiframe frames]  ->  step  ->  [results]  ->  drawer

The reader thread groups frames into batches of ``video_multiframe``; the
step (the calling thread) pads a short last batch with copies of its last
frame, so every call has the same shape, runs the pipeline (fast NMS on
the card, or the traditional host NMS) and, for lincomb masks, upsamples
and binarises the padded masks to the frame size on the device; the
drawer thread brings each batch's results to the host, pastes direct masks
into their boxes there (``finish_masks_direct``), draws the detections and
hands each frame to the writer, the frame sink and the playback window.
The results queue holds two batches, so the device works on the next batch
while the host draws this one.

Frames come from a video file or webcam index (``path``, read with
OpenCV as in JAX; OpenCV is imported only there, and without it the path
raises an ``ImportError`` that says so) or from memory: an array
``[N, H, W, 3]`` or an iterable of BGR ``uint8`` frames of one size.  Drawn
frames go to ``out_path`` (an OpenCV ``VideoWriter``) and/or to ``sink``, a
callable or an object with ``write``, frame by frame.  The live window
(``display``) is OpenCV's too, with JAX's headless fallback
(:func:`_display_available`).  Drawing boxes and text needs OpenCV;
masks alone (``display_bboxes=False, display_text=False``,
``display_fps=False``) are drawn in numpy.
"""

from __future__ import annotations

import itertools
import os
import queue
import sys
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from yolact_tpu_torch.config import MaskType, YolactConfig
from yolact_tpu_torch.detect.postprocess import (finish_masks_direct,
                                                 upsample_masks_device)
from yolact_tpu_torch.eval.display import draw_detections
from yolact_tpu_torch.eval.evaluate import sanitize_boxes_np
from yolact_tpu_torch.eval.traditional import TraditionalPipeline
from yolact_tpu_torch.infer import Pipeline
from yolact_tpu_torch.utils.functions import MovingAverage


class PlaybackStabilizer:
    """Playback-rate stabilizer for live display (eval.py:718-789).

    The producer fills a frame buffer at compute speed; the consumer
    paces itself so playback is smooth even when compute jitters: the
    per-frame sleep target drifts up when the buffer runs low (play
    slower, let the buffer refill) and down when it overfills, clamped
    at the source frame time for files (webcams may play faster).
    ``sleep_target(...)`` returns how long to wait before showing the
    next frame: ``max(2 * target - avg_frame_time, 0)``, the reference's
    proportional correction toward the drifting target.
    """

    def __init__(self, target_fps: float, buffer_target: int,
                 is_webcam: bool = False, step: float = 0.0005):
        self.frame_time_target = 1.0 / max(target_fps, 1e-6)
        self.stabilized = self.frame_time_target
        self.buffer_target = buffer_target
        self.is_webcam = is_webcam
        self.step = step

    def sleep_target(self, buffer_size: int, avg_frame_time: float,
                     vid_done: bool = False) -> float:
        if not vid_done:
            if buffer_size < self.buffer_target:
                self.stabilized += self.step
            elif buffer_size > self.buffer_target:
                self.stabilized = max(self.stabilized - self.step, 0.0)
            new_target = self.stabilized if self.is_webcam else \
                max(self.stabilized, self.frame_time_target)
        else:
            new_target = self.frame_time_target
        return max(2 * new_target - avg_frame_time, 0.0)


def _import_cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f'evalvideo: {what} needs OpenCV (the cv2 module), which is not '
            f'installed; pass the frames as an array [N, H, W, 3] or an '
            f'iterable of BGR frames, and a frame sink for the output') \
            from e
    return cv2


def _display_available() -> bool:
    """True when cv2 can open a HighGUI window (headless rigs cannot).

    Checks the display environment BEFORE touching HighGUI: on a headless
    Linux box some cv2 builds abort() inside namedWindow instead of
    raising cv2.error, which would take the whole process down.  Playback
    runs on a secondary thread, like the reference's play_video thread, so
    macOS (whose HighGUI needs the main thread) is unsupported, as
    upstream."""
    if sys.platform.startswith('linux') and \
            not (os.environ.get('DISPLAY') or
                 os.environ.get('WAYLAND_DISPLAY')):
        return False
    cv2 = _import_cv2('a display window')
    try:
        cv2.namedWindow('__yolact_probe__')
        cv2.destroyWindow('__yolact_probe__')
        return True
    except cv2.error:
        return False


def _play_loop(win_name, buffer_q, stabilizer, stop, producer_done,
               frame_times):
    """Consumer thread: imshow frames from the buffer at a stabilized
    rate; Escape closes (eval.py:752-758).  Always sets ``stop`` on exit,
    so a dying GUI cannot leave the producer blocked on a full buffer."""
    cv2 = _import_cv2('a display window')
    try:
        last = None
        while not stop.is_set():
            t0 = time.perf_counter()
            frame = None
            try:
                frame = buffer_q.get(timeout=0.05)
            except queue.Empty:
                if producer_done.is_set():
                    break
            if frame is None and producer_done.is_set() and buffer_q.empty():
                break
            if frame is not None:
                now = time.perf_counter()
                if last is not None:
                    frame_times.add(now - last)
                last = now
                cv2.imshow(win_name, frame)
            if cv2.waitKey(1) == 27:      # Escape closes
                break
            target = stabilizer.sleep_target(
                buffer_q.qsize(), frame_times.get_avg(),
                vid_done=producer_done.is_set())
            deadline = t0 + target - 0.001
            while time.perf_counter() < deadline and not stop.is_set():
                time.sleep(0.001)
    finally:
        stop.set()
        try:
            cv2.destroyAllWindows()
        except Exception:
            pass


class _Source:
    """Frames from a file or webcam (OpenCV) or from memory: ``read()``
    gives the next BGR frame or None, plus the frame rate, size and count
    (0 when unknown)."""

    def __init__(self, path, max_frames: int):
        self.cap = None
        self.is_webcam = False
        if isinstance(path, str):
            cv2 = _import_cv2(f'reading {path!r}')
            self.is_webcam = path.isdigit()
            self.cap = cv2.VideoCapture(int(path) if self.is_webcam
                                        else path)
            if not self.cap.isOpened():
                raise FileNotFoundError(f'could not open video {path}')
            self.fps = round(self.cap.get(cv2.CAP_PROP_FPS)) or 30
            self.size = (round(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                         round(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
            num_frames = round(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        else:
            num_frames = len(path) if hasattr(path, '__len__') else 0
            frames = iter(path)
            first = next(frames, None)
            if first is None:
                raise ValueError('evalvideo: the frame source is empty')
            first = np.asarray(first)
            if first.ndim != 3 or first.shape[2] != 3:
                raise ValueError(f'evalvideo: frames must be [H, W, 3] BGR, '
                                 f'got {first.shape}')
            self.frames = itertools.chain([first], frames)
            self.fps = 30
            self.size = (first.shape[1], first.shape[0])
        if max_frames > 0:
            num_frames = min(num_frames, max_frames) if num_frames > 0 \
                else max_frames
        self.num_frames = num_frames

    def read(self) -> Optional[np.ndarray]:
        if self.cap is not None:
            ok, frame = self.cap.read()
            return frame if ok else None
        frame = next(self.frames, None)
        if frame is None:
            return None
        frame = np.asarray(frame)
        if (frame.shape[1], frame.shape[0]) != self.size:
            raise ValueError(f'evalvideo: frame of {frame.shape[:2]} in a '
                             f'video of {self.size[::-1]}')
        return frame

    def release(self):
        if self.cap is not None:
            self.cap.release()


def _put(q: 'queue.Queue', item, stop: threading.Event) -> bool:
    """A put that gives up once ``stop`` is set (the consumer is gone)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _get(q: 'queue.Queue', stop: threading.Event):
    """A get that gives None once ``stop`` is set (the producer is gone)."""
    while not stop.is_set():
        try:
            return q.get(timeout=0.1)
        except queue.Empty:
            continue
    return None


def evalvideo(cfg: YolactConfig, state_dict: Dict[str, torch.Tensor],
              path: Union[str, np.ndarray, Iterable[np.ndarray]],
              out_path: Optional[str] = None,
              video_multiframe: int = 4,
              score_threshold: float = 0.15,
              top_k: int = 15,
              display_fps: bool = True,
              emulate_playback: bool = False,
              display: bool = False,
              max_frames: int = -1,
              fast_nms: bool = True,
              cross_class_nms: bool = False,
              crop_masks: bool = True,
              device: Union[str, torch.device] = 'cuda:0',
              use_kernels: bool = True,
              sink: Optional[Union[Callable[[np.ndarray], None],
                                   object]] = None,
              display_masks: bool = True,
              display_bboxes: bool = True,
              display_text: bool = True,
              display_scores: bool = True) -> float:
    """Runs the video through the model and returns the average frames/s
    (the drawer's moving average over the last 100 frames, as JAX's).

    ``path``: a file or webcam index string, or frames in memory (see the
    module docstring).  ``state_dict`` holds the port's weights, the mask
    scorer's included for YOLACT++ configs; the model runs on ``device``
    in ``cfg.compute_dtype``; ``use_kernels``
    False runs the kernels' plain versions.  ``display`` plays the frames
    in a window (not when writing, as the reference), or warns and runs
    headless where no display is available."""
    source = _Source(path, max_frames)
    fw, fh = source.size
    num_frames = source.num_frames

    writer = None
    if out_path is not None:
        cv2 = _import_cv2(f'writing {out_path!r}')
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*'mp4v'),
                                 source.fps, (fw, fh))
    write_sink = getattr(sink, 'write', sink)

    display = display and out_path is None
    if display and not _display_available():
        print('No display available; processing without playback window.')
        display = False

    # the reference applies the NMS flags to the video path too
    # (eval.py:871-872 set them on net.detect before dispatch)
    if fast_nms:
        pipeline = Pipeline(cfg, state_dict, device,
                            use_cross_class_nms=cross_class_nms,
                            score_threshold=score_threshold,
                            crop_masks=crop_masks, use_kernels=use_kernels,
                            preprocess=True)
    else:
        pipeline = TraditionalPipeline(cfg, state_dict, device,
                                       score_threshold=score_threshold,
                                       preprocess=True,
                                       crop_masks=crop_masks,
                                       use_kernels=use_kernels)
    # the frame size is fixed for a video: lincomb masks are upsampled and
    # binarised on the device; direct masks are box-local patches, pasted
    # on the host (output_utils.py:101-120)
    direct_masks = cfg.mask_type == MaskType.DIRECT

    stop = threading.Event()
    producer_done = threading.Event()
    errors = []
    frame_q: 'queue.Queue' = queue.Queue(maxsize=3)
    result_q: 'queue.Queue' = queue.Queue(maxsize=2)

    def reader():
        read = 0
        try:
            while not stop.is_set() and (num_frames <= 0 or
                                         read < num_frames):
                frames = []
                while len(frames) < video_multiframe and \
                        (num_frames <= 0 or read < num_frames):
                    frame = source.read()
                    if frame is None:
                        break
                    frames.append(frame)
                    read += 1
                if not frames or not _put(frame_q, frames, stop):
                    break
                if len(frames) < video_multiframe:
                    break
        except BaseException as e:        # surfaced by the step
            errors.append(e)
        finally:
            _put(frame_q, None, stop)

    play_thread = buffer_q = None
    if display:
        # bounded: the producer blocks once about 2 s of frames wait
        buffer_q = queue.Queue(maxsize=max(2 * source.fps,
                                           4 * video_multiframe))
        stabilizer = PlaybackStabilizer(source.fps, video_multiframe,
                                        is_webcam=source.is_webcam)
        play_thread = threading.Thread(
            target=_play_loop,
            args=(str(path) if isinstance(path, str) else 'video',
                  buffer_q, stabilizer, stop, producer_done,
                  MovingAverage(100)),
            daemon=True)

    frame_times = MovingAverage(100)
    state = {'fps': 0.0, 'processed': 0, 't_last': time.perf_counter()}

    def draw(entry):
        frames, n_real, out, masks = entry
        valid = out.valid.cpu().numpy()
        classes = out.classes.cpu().numpy()
        # prep_display forces rescore_bbox=True (eval.py:147-149): plus
        # configs draw maskiou-rescored scores
        scores = (out.mask_scores if out.mask_scores is not None
                  and cfg.rescore_mask else out.scores).cpu().numpy()
        boxes = out.boxes.cpu().numpy()
        masks = masks.cpu().numpy()
        for i in range(n_real):
            n = int(valid[i].sum())
            boxes_abs = sanitize_boxes_np(boxes[i][:n], fw, fh)
            full_masks = finish_masks_direct(masks[i][:n], boxes_abs, fw, fh) \
                if direct_masks else masks[i][:n]
            now = time.perf_counter()
            frame_times.add(now - state['t_last'])
            state['t_last'] = now
            state['fps'] = 1.0 / max(frame_times.get_avg(), 1e-6)
            img = draw_detections(
                cfg, frames[i], classes[i][:n], scores[i][:n], boxes_abs,
                full_masks, top_k=top_k, score_threshold=score_threshold,
                display_masks=display_masks, display_bboxes=display_bboxes,
                display_text=display_text, display_scores=display_scores,
                fps_str=f'{state["fps"]:.1f} fps' if display_fps else '')
            if writer is not None:
                writer.write(img)
            if write_sink is not None:
                write_sink(img)
            if buffer_q is not None:
                _put(buffer_q, img, stop)
            state['processed'] += 1
            if emulate_playback:
                # pace the output at the source frame rate
                budget = 1.0 / source.fps - (time.perf_counter() - now)
                if budget > 0:
                    time.sleep(budget)
        print(f'\rProcessing: {state["processed"]} frames | '
              f'{state["fps"]:.2f} fps  ', end='')

    def drawer():
        try:
            while True:
                entry = _get(result_q, stop)
                if entry is None:
                    break
                draw(entry)
        except BaseException as e:        # surfaced by the step
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=reader, daemon=True),
               threading.Thread(target=drawer, daemon=True)]
    for t in threads:
        t.start()
    if play_thread is not None:
        play_thread.start()
    try:
        while True:
            frames = _get(frame_q, stop)
            if frames is None:
                break
            batch = np.stack([np.asarray(f, np.float32) for f in frames])
            n_real = len(frames)
            if n_real < video_multiframe:
                # pad the last short batch: every call has the same shape
                batch = np.concatenate([batch, np.repeat(
                    batch[-1:], video_multiframe - n_real, axis=0)])
            out = pipeline(batch)
            masks = out.masks
            if not direct_masks:
                with torch.inference_mode():
                    masks = upsample_masks_device(masks, (fh, fw))
            if not _put(result_q, (frames, n_real, out, masks), stop):
                break
    except BaseException:
        stop.set()
        raise
    finally:
        _put(result_q, None, stop)
        threads[1].join()
        print()
        producer_done.set()
        if play_thread is not None:
            # the rest of the playback lasts at most the buffer at its rate
            play_thread.join(timeout=buffer_q.qsize() / max(source.fps, 1)
                             + 10)
        stop.set()
        # the reader must be out of cap.read() before the release:
        # VideoCapture is not thread-safe
        threads[0].join(timeout=5)
        source.release()
        if writer is not None:
            writer.release()
    if errors:
        raise errors[0]
    return state['fps']
