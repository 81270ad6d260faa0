"""The yardstick: the card's peaks, the work of the model and the least
time of each hand-written kernel at a cell's shapes.

Everything here is computed from shapes and from the frozen reference
(``reference/``), never from what the port runs, so that a change to the
port that drops work does not change its own denominator.

* Peaks: NVIDIA's H100 SXM data sheet, dense, at 700 W.
* :func:`forward_flops`: ``torch.utils.flop_counter.FlopCounterMode``
  over the reference's forward on the meta device (convolutions and
  matrix products, 2 FLOPs a multiply-add; the plain 7x7/s2 stem, the
  DCN GEMM).  The configuration files hold the count, and a test holds
  the files to this function.
* Kernel bounds (``bound``): the larger of the bytes the kernel must move
  (each input read once, each output written once) over the memory rate,
  and its operations over the rate of their type.  The formulae are the
  ones ``chip_smoke.py`` (``bound``, ``small_kernel_bounds``, the stem,
  DCN and ``dcn_col2im`` timing) used for the port's kernel table.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_TENSOR_OPS_PER_S = 494.7e12
BF16_TENSOR_OPS_PER_S = 989e12
BYTES = {'float32': 4, 'bfloat16': 2}


def bound(nbytes: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    """(least seconds, 'bytes' or 'operations'): the larger of `nbytes`
    over the memory rate and `ops` over `ops_per_s`."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def mask_assembly(b: int, d: int, hp: int, wp: int, md: int):
    """float32 prototypes [b, hp, wp, md], coefficients [b, d, md], boxes
    [b, d, 4] -> masks [b, d, hp, wp]: the md-term dot product (2 md
    operations) and the sigmoid (3) a mask pixel."""
    out = b * d * hp * wp
    nbytes = 4 * (b * hp * wp * md + b * d * md + b * d * 4 + out)
    return bound(nbytes, out * (2 * md + 3), FP32_OPS_PER_S)


def nms_iou_max(n: int, k: int):
    """float32 boxes [n, k, 4] -> [n, k]: 13 operations an IoU pair (4
    min/max, 2 subtractions, 2 clamps and a product for the intersection,
    2 for the union, the divide, the running max)."""
    nbytes = 4 * (n * k * 4 + n * k)
    return bound(nbytes, 13 * n * k * (k - 1) // 2, FP32_OPS_PER_S)


def stem_s2d(b: int, h: int, w: int, dtype: str):
    """x [b, 12, h, w], w2 [64, 12, 4, 4] -> [b, 64, h, w] in `dtype`:
    2 * 12 * 16 operations an output; bfloat16 on the tensor cores, float32
    as three TF32 products (split TF32)."""
    e = BYTES[dtype]
    out = b * 64 * h * w
    nbytes = e * (b * 12 * h * w + 64 * 12 * 16 + out)
    ops = 2 * out * 12 * 16
    if dtype == 'bfloat16':
        return bound(nbytes, ops, BF16_TENSOR_OPS_PER_S)
    return bound(nbytes, 3 * ops, TF32_TENSOR_OPS_PER_S)


def dcn_im2col(b: int, cin: int, h: int, w: int, ho: int, wo: int,
               dtype: str, k: int = 3):
    """x [b, h, w, cin] in `dtype`, float32 offsets [b, 2k², ho, wo], the
    mask [b, k², ho, wo] in `dtype` -> columns [b ho wo, k² cin]: 8
    operations a column entry (4 corner products and sums)."""
    e = BYTES[dtype]
    cols = b * ho * wo * k * k * cin
    nbytes = (e * b * h * w * cin + 4 * b * 2 * k * k * ho * wo
              + e * b * k * k * ho * wo + e * cols)
    return bound(nbytes, 8 * cols, FP32_OPS_PER_S)


def dcn_col2im(b: int, cin: int, h: int, w: int, ho: int, wo: int,
               dtype: str, k: int = 3):
    """The DCN backward: column gradients [b ho wo, k² cin] with x, the
    offsets and the mask read, and grad_x (float32), the offset and mask
    gradients written: 16 operations a column entry (4 multiply-adds for
    the corner sums, 4 products for grad_x)."""
    e = BYTES[dtype]
    cols = b * ho * wo * k * k * cin
    read = (e * cols + e * b * h * w * cin + 4 * b * 2 * k * k * ho * wo
            + e * b * k * k * ho * wo)
    written = (4 * b * h * w * cin + 4 * b * 2 * k * k * ho * wo
               + e * b * k * k * ho * wo)
    return bound(read + written, 16 * cols, FP32_OPS_PER_S)


def reference_model(cfg, device='meta'):
    """The reference's Yolact for `cfg` (a reference config)."""
    import torch

    from benchmark.reference.models.yolact import Yolact
    with torch.device(device):
        return Yolact(cfg)


def forward_flops(cfg, batch: int = 1) -> float:
    """FLOPs an image of the reference's inference forward (the model, not
    the mask scorer, which runs after detection) at [batch, 3, S, S], on
    the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    model = reference_model(cfg).eval()
    x = torch.zeros(batch, 3, cfg.max_size, cfg.max_size, device='meta')
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x, use_kernels=False)
    return counter.get_total_flops() / batch


def dcn_shapes(cfg) -> List[Tuple[int, int, int, int, int]]:
    """(cin, h, w, ho, wo) of every DCN layer of the reference's model at
    [1, 3, S, S], in forward order (meta device)."""
    import torch

    from benchmark.reference.models.resnet import DCNLayer
    model = reference_model(cfg).eval()
    shapes = []

    def hook(conv, args, out):
        # the layer's offset conv sees its input and gives its output size
        x = args[0]
        shapes.append((x.shape[1], x.shape[2], x.shape[3], out.shape[2],
                       out.shape[3]))

    for m in model.modules():
        if isinstance(m, DCNLayer):
            m.conv_offset_mask.register_forward_hook(hook)
    x = torch.zeros(1, 3, cfg.max_size, cfg.max_size, device='meta')
    with torch.no_grad():
        model(x, use_kernels=False)
    return shapes


def infer_kernel_bounds(cfg, batch: int, compute_dtype: str,
                        s2d_stem: bool) -> Dict[str, float]:
    """Least seconds a ``Pipeline`` call of `batch` frames spends in each
    hand-written kernel it launches, summed over its launches: the
    pruned NMS tail's IoU max ([batch (C-1), min(top_k, candidates)]),
    mask assembly over the prototypes, the s2d stem (raw frames on a
    ResNet) and the DCN sampling of every DCN layer."""
    from benchmark.reference.ops.anchors import generate_priors
    num_priors = generate_priors(cfg, (cfg.max_size, cfg.max_size)).shape[0]
    k = min(cfg.nms_top_k, cfg.nms_candidates or num_priors, num_priors)
    proto = proto_size(cfg)
    bounds = {
        'fast_nms_iou_max_kernel':
            nms_iou_max(batch * (cfg.num_classes - 1), k)[0],
        'mask_assembly_kernel':
            mask_assembly(batch, cfg.max_num_detections, proto[0], proto[1],
                          cfg.mask_dim)[0],
    }
    if s2d_stem:
        half = cfg.max_size // 2
        name = ('stem_s2d_mma_kernel' if compute_dtype == 'bfloat16'
                else 'stem_s2d_tf32_kernel')
        bounds[name] = stem_s2d(batch, half, half, compute_dtype)[0]
    shapes = dcn_shapes(cfg)
    if shapes:
        bounds['dcn_im2col_kernel'] = sum(
            dcn_im2col(batch, *s, compute_dtype)[0] for s in shapes)
    return bounds


def train_kernel_bounds(cfg, batch: int, compute_dtype: str,
                        s2d_stem: bool, remat: str) -> Dict[str, float]:
    """Least seconds a train step of `batch` images spends in each
    hand-written kernel it launches: the s2d stem's forward (its gradients
    are library convolutions), the DCN sampling (twice a layer where
    ``train_remat`` recomputes the DCN layers in the backward) and the DCN
    backward, ``dcn_col2im``, once a layer."""
    bounds = {}
    if s2d_stem:
        half = cfg.max_size // 2
        name = ('stem_s2d_mma_kernel' if compute_dtype == 'bfloat16'
                else 'stem_s2d_tf32_kernel')
        bounds[name] = stem_s2d(batch, half, half, compute_dtype)[0]
    shapes = dcn_shapes(cfg)
    if shapes:
        forwards = 2 if remat in ('dcn', 'all') else 1
        bounds['dcn_im2col_kernel'] = forwards * sum(
            dcn_im2col(batch, *s, compute_dtype)[0] for s in shapes)
        bounds['dcn_col2im_kernel'] = sum(
            dcn_col2im(batch, *s, compute_dtype)[0] for s in shapes)
    return bounds


def proto_size(cfg) -> Tuple[int, int]:
    """The prototypes' [Hp, Wp] at the config's input size."""
    import torch
    model = reference_model(cfg).eval()
    x = torch.zeros(1, 3, cfg.max_size, cfg.max_size, device='meta')
    with torch.no_grad():
        out = model(x, use_kernels=False)
    return tuple(out['proto'].shape[1:3])
