"""Detection visualisation (prep_display equivalent, ``eval.py:135-262``).

The port's copy of ``yolact_tpu/eval/display.py``.

Alpha-composites instance masks with per-detection colors using the same
cumulative-product formulation as the reference, then draws boxes/labels with
cv2 (imported only for those).  Pure numpy — the mask compositing cost is
trivial next to the network.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from yolact_tpu_torch.config import COLORS, YolactConfig


def display_lincomb(proto_data: np.ndarray, coeffs: np.ndarray,
                    out_path: str = 'lincomb.png', det_idx: int = 0,
                    mask_activation: str = 'sigmoid') -> np.ndarray:
    """Visualise how prototype masks combine into one detection's mask
    (reference ``output_utils.py:147-189``): a grid of the prototypes
    weighted by |coefficient| order plus the running combination.

    proto_data: [Hp, Wp, k]; coeffs: [n_dets, k].  Returns the grid image
    and saves it to `out_path` (headless: file output instead of plt.show).
    """
    ph, pw, k = proto_data.shape
    c = np.asarray(coeffs[det_idx])
    order = np.argsort(-np.abs(c))
    arr_w = int(np.ceil(np.sqrt(k)))
    arr_h = int(np.ceil(k / arr_w))
    grid = np.zeros((arr_h * ph, arr_w * 2 * pw), np.float32)
    running = np.zeros((ph, pw), np.float32)
    for i, idx in enumerate(order):
        y, x = divmod(i, arr_w)
        p = np.asarray(proto_data[:, :, idx])
        denom = max(float(np.abs(p).max()), 1e-6)
        grid[y * ph:(y + 1) * ph, x * pw:(x + 1) * pw] = p / denom * c[idx]
        running += p * c[idx]
        comb = 1 / (1 + np.exp(-running)) if mask_activation == 'sigmoid' \
            else running
        grid[y * ph:(y + 1) * ph,
             (arr_w + x) * pw:(arr_w + x + 1) * pw] = (comb > 0.5)
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    plt.figure(figsize=(12, 6))
    plt.imshow(grid)
    plt.title('prototypes (left, |coeff| order) / running combination (right)')
    plt.axis('off')
    plt.savefig(out_path, dpi=120, bbox_inches='tight')
    plt.close()
    return grid


def get_color(rank: int, class_id: int, class_color: bool = False,
              bgr: bool = False):
    """Color by display rank, or by class id when class_color (the
    reference indexes its score-sorted arrays by rank; here detections
    arrive unsorted, so the caller passes the detection's class id)."""
    color_idx = (int(class_id) * 5 if class_color else rank * 5) % len(COLORS)
    color = COLORS[color_idx]
    return (color[2], color[1], color[0]) if bgr else color


def draw_detections(cfg: YolactConfig, img_bgr: np.ndarray,
                    classes: np.ndarray, scores: np.ndarray,
                    boxes_abs: np.ndarray, masks: np.ndarray,
                    top_k: int = 15, score_threshold: float = 0.0,
                    mask_alpha: float = 0.45,
                    display_masks: bool = True,
                    display_bboxes: bool = True,
                    display_text: bool = True,
                    display_scores: bool = True,
                    class_color: bool = False,
                    fps_str: str = '') -> np.ndarray:
    """img_bgr: uint8 [h, w, 3]; masks: bool/float [n, h, w] full size.
    The masks are composited in numpy; boxes, text and ``fps_str`` are
    drawn with cv2, imported only when there are some to draw."""
    order = np.argsort(-scores)[:top_k]
    n = 0
    for j in order:
        if scores[j] < score_threshold:
            break
        n += 1
    order = order[:n]

    img = img_bgr.astype(np.float32) / 255.0

    if display_masks and n > 0:
        # iterative form of the reference's cumprod compositing
        # (eval.py:199-209): img = img*inv_a[j] + color[j]*a*mask[j]
        for rank in reversed(range(n)):
            j = order[rank]
            m = masks[j].astype(np.float32)[..., None]
            color = np.array(get_color(rank, int(classes[j]), class_color,
                                       bgr=True), np.float32) / 255.0
            img = img * (1 - m * mask_alpha) + m * mask_alpha * color

    img_numpy = (img * 255).astype(np.uint8)

    if fps_str:
        import cv2
        font = cv2.FONT_HERSHEY_DUPLEX
        tw, th = cv2.getTextSize(fps_str, font, 0.6, 1)[0]
        img_numpy[0:th + 8, 0:tw + 8] = (
            img_numpy[0:th + 8, 0:tw + 8] * 0.6).astype(np.uint8)
        cv2.putText(img_numpy, fps_str, (4, th + 2), font, 0.6,
                    (255, 255, 255), 1, cv2.LINE_AA)

    if n == 0:
        return img_numpy

    if display_text or display_bboxes:
        import cv2
        for rank in reversed(range(n)):
            j = order[rank]
            x1, y1, x2, y2 = (int(v) for v in boxes_abs[j])
            color = get_color(rank, int(classes[j]), class_color, bgr=True)
            score = scores[j]
            if display_bboxes:
                cv2.rectangle(img_numpy, (x1, y1), (x2, y2), color, 1)
            if display_text:
                name = cfg.dataset.class_names[int(classes[j])]
                text = f'{name}: {score:.2f}' if display_scores else name
                font = cv2.FONT_HERSHEY_DUPLEX
                tw, th = cv2.getTextSize(text, font, 0.6, 1)[0]
                cv2.rectangle(img_numpy, (x1, y1), (x1 + tw, y1 - th - 4),
                              color, -1)
                cv2.putText(img_numpy, text, (x1, y1 - 3), font, 0.6,
                            (255, 255, 255), 1, cv2.LINE_AA)
    return img_numpy
