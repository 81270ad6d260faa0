"""The port's two kernels (yolact_tpu_torch.kernels): the plain PyTorch
versions against the JAX package's Pallas kernels (interpret mode) and XLA
references on the CPU.  The CUDA kernels are held against the plain
versions in test_torch_cuda.py.

Tolerances: mask assembly 1e-5 (a K-term float32 dot product summed in
another order, then a sigmoid), IoU max 1e-6 (the same float operations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from yolact_tpu.detect.detection import _triu_max
from yolact_tpu.kernels.mask_assembly import (assemble_masks_batched_pallas,
                                              assemble_masks_pallas,
                                              assemble_masks_xla)
from yolact_tpu.kernels.nms_pallas import nms_iou_max_pallas
from yolact_tpu.ops.boxes import jaccard as jax_jaccard
from yolact_tpu_torch.kernels import _build, mask_assembly, nms

torch.set_num_threads(2)


def _mask_inputs(rng, b, hp, wp, md, d):
    proto = rng.rand(b, hp, wp, md).astype(np.float32)
    coeffs = np.tanh(rng.randn(b, d, md)).astype(np.float32)
    xy1 = rng.rand(b, d, 2) * 0.6
    wh = rng.rand(b, d, 2) * 0.4 + 0.02
    boxes = np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)
    # inverted boxes (x1 > x2, y1 > y2), boxes out of [0, 1], a zero-area
    # box and one on exact pixel edges
    boxes[:, 0] = boxes[:, 0, [2, 3, 0, 1]]
    boxes[:, 1] = [-0.3, -0.2, 1.4, 1.1]
    boxes[:, 2] = [0.5, 0.5, 0.5, 0.5]
    boxes[:, 3] = [2 / wp, 3 / hp, 9 / wp, 7 / hp]
    return proto, coeffs, boxes


def _iou_inputs(rng, n, k):
    xy1 = rng.rand(n, k, 2) * 0.6
    wh = rng.rand(n, k, 2) * 0.3 + 0.02
    boxes = np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]                 # duplicate: IoU exactly 1
    boxes[:, 2, 2:] = boxes[:, 2, :2]         # zero-area boxes
    boxes[:, 3] = 0.0
    boxes[:, 4] = 0.0
    return boxes


def _with_nonfinite(boxes):
    boxes = boxes.copy()
    boxes[:, 5] = [0.1, 0.1, np.inf, np.inf]
    boxes[:, 6] = [-np.inf, 0.2, np.inf, 0.4]
    boxes[:, 7] = [np.nan, 0.1, 0.3, 0.3]
    return boxes


@pytest.mark.parametrize('d', [50, 37])
def test_plain_mask_assembly_matches_pallas_and_xla(rng, d):
    proto, coeffs, boxes = _mask_inputs(rng, 2, 16, 12, 8, d)
    got = mask_assembly.assemble_masks_plain(
        torch.from_numpy(proto), torch.from_numpy(coeffs),
        torch.from_numpy(boxes)).numpy()
    assert got.shape == (2, d, 16, 12)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(assemble_masks_batched_pallas(
            jnp.asarray(proto), jnp.asarray(coeffs), jnp.asarray(boxes)))
        pallas0 = np.asarray(assemble_masks_pallas(
            jnp.asarray(proto[0]), jnp.asarray(coeffs[0]),
            jnp.asarray(boxes[0])))
    xla = np.stack([np.asarray(assemble_masks_xla(
        jnp.asarray(p), jnp.asarray(c), jnp.asarray(b)))
        for p, c, b in zip(proto, coeffs, boxes)])
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], pallas0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-5)
    # the crop is exact: the same pixels are zero on both sides
    np.testing.assert_array_equal(got == 0, xla == 0)


def test_plain_iou_max_matches_pallas_and_xla(rng):
    boxes = _iou_inputs(rng, 6, 37)
    got = nms.nms_iou_max_plain(torch.from_numpy(boxes)).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(nms_iou_max_pallas(jnp.asarray(boxes)))
    jb = jnp.asarray(boxes)
    xla = np.asarray(_triu_max(jax_jaccard(jb, jb)))
    assert got.shape == (6, 37)
    assert (got[:, 1] == 1.0).all() and (got[:, 0] == 0.0).all()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-6)


def test_plain_iou_max_nonfinite_boxes_match_xla(rng):
    """Infinite and NaN coordinates: the guarded IoU maps every NaN
    union to IoU 0, so nothing NaN reaches the max, as in JAX."""
    boxes = _with_nonfinite(_iou_inputs(rng, 3, 16))
    got = nms.nms_iou_max_plain(torch.from_numpy(boxes)).numpy()
    jb = jnp.asarray(boxes)
    want = np.asarray(_triu_max(jax_jaccard(jb, jb)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_wrappers_take_plain_version_on_cpu(rng):
    proto, coeffs, boxes = _mask_inputs(rng, 1, 8, 8, 4, 5)
    n0, m0 = nms.launches, mask_assembly.launches
    t = [torch.from_numpy(a) for a in (proto, coeffs, boxes)]
    assert torch.equal(mask_assembly.assemble_masks(*t),
                       mask_assembly.assemble_masks_plain(*t))
    b = torch.from_numpy(_iou_inputs(rng, 2, 9))
    assert torch.equal(nms.nms_iou_max(b), nms.nms_iou_max_plain(b))
    assert (nms.launches, mask_assembly.launches) == (n0, m0)


def test_build_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present; this checks the no-GPU error')
    with pytest.raises(RuntimeError, match='CUDA device'):
        _build.load()


def test_build_key_follows_source_content(tmp_path):
    src = tmp_path / 'k.cu'
    src.write_text('__global__ void k() {}\n')
    before = _build._digest([str(src)])
    assert _build._digest([str(src)]) == before
    src.write_text('__global__ void k() { }\n')
    assert _build._digest([str(src)]) != before
