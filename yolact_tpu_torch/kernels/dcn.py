"""Modulated deformable convolution (DCNv2): the sampling kernel and its
plain PyTorch version.

Port of ``yolact_tpu/kernels/dcn.py:deform_conv2d`` (forward) and its
sampler ``_bilinear_gather_block``.  The TPU package probed this gather
with four Pallas kernels (``scripts/bench_gather2.py:pallas_kernel``,
``taa_kernel``, ``taa4_kernel``, ``scripts/probe_sameshape_gather.py:
kernel``) and ships it as an XLA gather; here it is one CUDA kernel,
``csrc/dcn_im2col.cu``, that writes the modulated im2col columns.  The
GEMM stays ``torch.matmul``, as JAX leaves it to an XLA ``dot_general``.

Layouts at the public functions are the port's NCHW: ``x [B, Cin, H, W]``
(contiguous, or ``channels_last``, which the sampler reads without a
copy), ``offset [B, 2*K*K, Ho, Wo]`` float32 with channels ``2t`` (dy) and
``2t+1`` (dx) for tap ``t = i*K + j``, ``mask [B, K*K, Ho, Wo]`` (after
the sigmoid), ``weight [Cout, Cin, K, K]``.  The sampler reads x as NHWC
and the columns are JAX's layout ``[B*Ho*Wo, K*K*Cin]`` (column
``t*Cin + c``), so the GEMM ``cols @ weight[Cout, K*K*Cin]^T`` has leading
dimensions ``K*K*Cin`` and ``Cout`` (multiples of 8 at yolact_plus_base,
which cuBLAS's aligned kernels need) and lands in NHWC:
:func:`deform_conv2d` returns it as a ``channels_last`` view of
``[B, Cout, Ho, Wo]``.

Rounding follows the JAX sampler (``_bilinear_gather_block``): the corner
weights ``wy * wx * valid`` are float32 and cast to the input dtype, each
corner value times its weight is one product in that dtype, the four
products are summed in float32 in corner order (top-left, top-right,
bottom-left, bottom-right) and rounded once to the input dtype, as
``jnp.sum`` does for bfloat16, and the sum is multiplied by the mask cast
to that dtype.  Validity is tested on
the integer corner indices; an invalid corner reads the clamped pixel and
weighs it by exactly 0, as ``_bilinear_gather_rows`` does once XLA has
turned its ``* valid`` into a select.  Non-finite offsets behave as in
JAX: XLA converts a NaN floor to the integer 0, so a NaN coordinate has
corners inside the map and NaN weights (NaN columns), while an infinite
one has every corner outside (zero columns).  The sample grid is
computed in float32 (JAX builds it in the input dtype, which is exact for
maps under 256 pixels, every map of the YOLACT++ configs).

Output rows from ``row0``.  Every function takes ``row0`` (default 0):
the offsets and the mask hold ``Ho`` output rows of the map from ``row0``
on (``row0 + Ho`` at most the map's output height), and output row ``i``
samples at ``(row0 + i) * stride - padding + ky * dilation`` plus its
offset, over the whole map x.  A rank of a spatial split
(``models/resnet.py:DCNLayer``) passes the whole map and its own output
rows; with ``row0 = 0`` and every row it is the whole map's call.  The
kernels take ``row0`` as one more integer, in integer arithmetic.

:func:`dcn_columns` and :func:`deform_conv2d` take the plain version only
for tensors on the CPU.  For CUDA tensors they launch the kernel or raise.
The custom ops ``torch.ops.yolact_tpu_torch.dcn_columns`` and
``dcn_col2im`` carry both for ``torch.export`` and for autograd on the card
(``_build.route``).

Gradients.  On the card autograd records the ``dcn_columns`` op, whose
backward (``register_autograd``) is the ``dcn_col2im`` op, a second
hand-written kernel,
``csrc/dcn_col2im.cu`` (:func:`dcn_col2im`): from the columns' gradient it
accumulates ``grad_x`` per tile of output pixels over the tile's window of
input pixels, in float32, and adds each window pixel into an NHWC buffer
(rounded once to x's dtype) with 16-byte reductions; corners outside the
window go straight to the buffer.  The offset and mask gradients are
reduced over the channels in the same pass.  The kernel plans its own
launch (tiles, windows, channel chunks); :func:`col2im_corners` and
:func:`col2im_reductions` say, from its constants, where each corner goes
and how many global reductions that costs.  It stands for the JAX
package's hand-written XLA backward
(``yolact_tpu/kernels/dcn.py:_bilinear_gather_bwd`` and the mask
product's VJP), which is not a Pallas kernel.  The GEMM's gradients stay
``torch.matmul``'s own.  The plain version of the backward,
:func:`dcn_col2im_plain`, is autograd through :func:`dcn_columns_plain`
(``torch.gather``'s backward is the scatter-add, the selected corner weights
carry the coordinate gradients, ``floor`` gives none; taken by
``torch.func.vjp``, which also works inside the op's CPU implementation,
below the autograd dispatch); on the CPU autograd runs through the plain
forward directly.  Corners outside the map (far and infinite offsets
included) add exactly nothing to any gradient; a NaN
offset, whose columns are NaN, has NaN gradients.  Two deltas from JAX in
bfloat16: JAX scatters ``grad_x`` in bfloat16, so its sum depends on the
order, while the kernel sums in float32 and rounds once; and the atomics'
order changes from run to run, so ``grad_x`` is reproducible to a tolerance,
not bit for bit.  The plain versions also take float64 (for
``torch.autograd.gradcheck``); the kernels take float32 and bfloat16.
"""

from __future__ import annotations

import functools
import os
import re
from typing import NamedTuple, Optional

import torch

from yolact_tpu_torch.kernels import _build

launches = 0        # sampling-kernel launches since import / reset
col2im_launches = 0  # backward-kernel launches since import / reset

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def out_size(size: int, k: int, stride: int, padding: int,
             dilation: int) -> int:
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def _check(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
           k: int, stride: int, padding: int, dilation: int,
           plain: bool = False, row0: int = 0):
    """Shapes, dtypes and layouts both versions take (`plain`: float64 x
    and offsets as well); returns (ho, wo).  The offsets hold ``ho`` output
    rows from `row0` on, within the map's output height."""
    if x.dim() != 4:
        raise ValueError(f'dcn: x must be [B, Cin, H, W], got '
                         f'{tuple(x.shape)}')
    f64 = plain and x.dtype == offset.dtype == torch.float64
    if x.dtype not in _DTYPE_CODES and not f64:
        raise ValueError(f'dcn: x dtype {x.dtype} is not float32 or bfloat16')
    if offset.dtype != torch.float32 and not f64:
        raise ValueError(f'dcn: offset must be float32, got {offset.dtype}')
    if not mask.is_floating_point():
        raise ValueError(f'dcn: mask must be floating point, got {mask.dtype}')
    if min(k, stride, dilation) < 1 or padding < 0 or row0 < 0:
        raise ValueError(f'dcn: bad geometry k={k} stride={stride} '
                         f'padding={padding} dilation={dilation} '
                         f'row0={row0}')
    b, _, h, w = x.shape
    h_out, wo = (out_size(n, k, stride, padding, dilation) for n in (h, w))
    ho = offset.shape[2] if offset.dim() == 4 else -1
    if (tuple(offset.shape) != (b, 2 * k * k, ho, wo)
            or row0 + ho > h_out):
        raise ValueError(f'dcn: offset must be {(b, 2 * k * k)} + (rows, '
                         f'{wo}) with row0 + rows <= {h_out} (row0 '
                         f'{row0}), got {tuple(offset.shape)}')
    if tuple(mask.shape) != (b, k * k, ho, wo):
        raise ValueError(f'dcn: mask must be {(b, k * k, ho, wo)}, got '
                         f'{tuple(mask.shape)}')
    if not ((x.is_contiguous()
             or x.is_contiguous(memory_format=torch.channels_last))
            and offset.is_contiguous() and mask.is_contiguous()):
        raise ValueError('dcn: x must be contiguous or channels_last, '
                         'offset and mask contiguous')
    if not (x.device == offset.device == mask.device):
        raise ValueError('dcn: inputs on different devices')
    return ho, wo


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H, W, C] contiguous: a view of a channels_last
    tensor, one copy of a contiguous one."""
    return x.permute(0, 2, 3, 1).contiguous()


def _corner_index(f: torch.Tensor, n: int) -> torch.Tensor:
    """floor(coordinate) as an integer, clamped to [-2, n] first (every
    corner beyond stays invalid, and no conversion overflows); NaN maps
    to 0, as XLA converts it."""
    return torch.nan_to_num(f, nan=0.0).clamp(-2, n).to(torch.int64)


def bilinear_sample_plain(x: torch.Tensor, ys: torch.Tensor,
                          xs: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C]; ys, xs [B, N] float32 pixel coordinates ->
    [B, N, C] in x's dtype: per-corner zero-outside bilinear samples (the
    signature of JAX's samplers)."""
    b, h, w, c = x.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    y0i = _corner_index(y0, h)
    x0i = _corner_index(x0, w)
    flat = x.reshape(b, h * w, c)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    out = None
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            yi = y0i + dy
            xi = x0i + dx
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            g = torch.gather(flat, 1, idx[:, :, None].expand(b, -1, c))
            # the factors are selected, not the product: the same value,
            # and an invalid corner's inf or NaN factor sends no NaN back
            # through the product's gradient
            weight = (torch.where(valid, wy, 0.0)
                      * torch.where(valid, wx, 0.0)).to(x.dtype)
            term = (g * weight[:, :, None]).to(acc)
            out = term if out is None else out + term
    return out.to(x.dtype)


def dcn_columns_plain(x: torch.Tensor, offset: torch.Tensor,
                      mask: torch.Tensor, k: int = 3, stride: int = 1,
                      padding: int = 1, dilation: int = 1,
                      row0: int = 0) -> torch.Tensor:
    """Modulated im2col columns [B*Ho*Wo, K*K*Cin] in x's dtype, column
    t*Cin + c.  Output row i is the map's row ``row0 + i`` (its samples
    at ``(row0 + i) * stride - padding + ky * dilation`` plus the offset):
    the offsets hold ``Ho`` rows from `row0` on."""
    ho, wo = _check(x, offset, mask, k, stride, padding, dilation, plain=True,
                    row0=row0)
    b, cin = x.shape[:2]
    kk = k * k
    dev = x.device
    tap = torch.arange(kk, device=dev)
    base_y = (((torch.arange(ho, device=dev) + row0) * stride
               - padding)[:, None, None]
              + (tap // k * dilation)[None, None, :]).to(offset.dtype)
    base_x = ((torch.arange(wo, device=dev) * stride - padding)[None, :, None]
              + (tap % k * dilation)[None, None, :]).to(offset.dtype)
    off = offset.view(b, kk, 2, ho, wo).permute(0, 3, 4, 1, 2)
    ys = (base_y + off[..., 0]).reshape(b, ho * wo * kk)
    xs = (base_x + off[..., 1]).reshape(b, ho * wo * kk)
    cols = bilinear_sample_plain(_nhwc(x), ys, xs).view(b, ho * wo, kk, cin)
    m = mask.to(x.dtype).view(b, kk, ho * wo).transpose(1, 2)
    cols = cols * m[:, :, :, None]
    return cols.view(b * ho * wo, kk * cin)


def _geometry(x, offset, mask, k, stride, padding, dilation, row0=0):
    """Checked launch arguments: (NHWC x, mask in x's dtype, the ints the
    C entry points take after the dtype code)."""
    ho, wo = _check(x, offset, mask, k, stride, padding, dilation,
                    row0=row0)
    b, cin, h, w = x.shape
    return (_nhwc(x), mask.to(x.dtype).contiguous(),
            (b, cin, h, w, ho, wo, k, stride, padding, dilation, row0))


def _launch_im2col(xh, offset, mask, dims) -> torch.Tensor:
    """The sampling kernel on checked CUDA tensors (xh NHWC)."""
    b, cin, _, _, ho, wo, k = dims[:7]
    cols = torch.empty((b * ho * wo, k * k * cin), dtype=xh.dtype,
                       device=xh.device)
    if cols.numel() == 0:
        return cols
    lib = _build.load()
    global launches
    with _build.device_guard(xh.device):
        _build.check(lib.yolact_dcn_im2col(
            xh.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            cols.data_ptr(), _DTYPE_CODES[xh.dtype], *dims,
            _build.stream_ptr(xh.device)), 'yolact_dcn_im2col')
    launches += 1
    return cols


class Col2imGeometry(NamedTuple):
    """The tiles and windows of csrc/dcn_col2im.cu (see
    :func:`col2im_geometry`)."""
    tile: int         # output pixels per side of a block's tile
    halo: int         # input pixels of the window beyond the receptive field
    window: int       # input pixels per side of the window
    cap: int          # corners listed per window pixel (more: global path)


_COL2IM_SOURCE = os.path.join(_build.CSRC, 'dcn_col2im.cu')


@functools.lru_cache(maxsize=None)
def _col2im_constants() -> dict:
    """kTile, kHalo and kCapSpare as csrc/dcn_col2im.cu defines them."""
    with open(_COL2IM_SOURCE) as f:
        text = f.read()
    found = dict(re.findall(r'^constexpr int (kTile|kHalo|kCapSpare) = '
                            r'(\d+);', text, re.M))
    if len(found) != 3:
        raise RuntimeError(f'{_COL2IM_SOURCE}: kTile, kHalo and kCapSpare '
                           f'not all found ({found})')
    return {k: int(v) for k, v in found.items()}


def col2im_geometry(k: int = 3, stride: int = 1,
                    dilation: int = 1) -> Col2imGeometry:
    """The backward kernel's tile and window for a k x k DCN, from its
    source's constants as its launch computes them: a window is the
    receptive field of the tile's output pixels (with the bottom-right
    corner of the last tap) and kHalo more input pixels on each side, so
    offsets within +-kHalo keep every corner in it; a window pixel lists
    4 k^2 / stride^2 corners (about as many as offsets near 0 put there)
    plus kCapSpare.  For the diagnostics below; the kernel plans its own
    launch."""
    c = _col2im_constants()
    tile, halo = c['kTile'], c['kHalo']
    return Col2imGeometry(
        tile, halo, stride * (tile - 1) + (k - 1) * dilation + 2 + 2 * halo,
        4 * k * k // (stride * stride) + c['kCapSpare'])


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _top_left_corners(offset, h, w, k, stride, padding, dilation, row0=0):
    """The forward's integer top-left corner of every sample: (y0, x0),
    each int64 [B, Ho, Wo, K*K] (floor, clamped, NaN to 0)."""
    b, _, ho, wo = offset.shape
    kk = k * k
    dev = offset.device
    tap = torch.arange(kk, device=dev)
    base_y = (((torch.arange(ho, device=dev) + row0) * stride
               - padding)[:, None, None]
              + tap // k * dilation).to(offset.dtype)
    base_x = ((torch.arange(wo, device=dev) * stride - padding)[None, :, None]
              + tap % k * dilation).to(offset.dtype)
    off = offset.view(b, kk, 2, ho, wo).permute(0, 3, 4, 1, 2)
    return (_corner_index(torch.floor(base_y + off[..., 0]), h),
            _corner_index(torch.floor(base_x + off[..., 1]), w))


_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def col2im_corners(offset: torch.Tensor, h: int, w: int, k: int = 3,
                   stride: int = 1, padding: int = 1, dilation: int = 1,
                   geometry: Optional[Col2imGeometry] = None,
                   row0: int = 0) -> torch.Tensor:
    """Where the backward kernel sends each corner's grad_x contribution:
    int8 [B, Ho, Wo, K*K, 4] (corners top-left, top-right, bottom-left,
    bottom-right), 0 for a corner outside the map (no contribution, as in
    the plain scatter), 1 for one inside its tile's window (listed in
    shared memory and summed by the pixel's lanes), 2 for one outside it
    (the global path; the kernel also sends a corner there when its
    pixel's list is full).  `geometry`: the kernel's by default; `row0`:
    the offsets' first output row (:func:`dcn_columns_plain`)."""
    b, _, ho, wo = offset.shape
    geo = geometry or col2im_geometry(k, stride, dilation)
    y0, x0 = _top_left_corners(offset, h, w, k, stride, padding, dilation,
                               row0)
    dev = offset.device
    win_y = (((torch.arange(ho, device=dev) // geo.tile) * geo.tile + row0)
             * stride - padding - geo.halo)[:, None, None]
    win_x = ((torch.arange(wo, device=dev) // geo.tile) * geo.tile * stride
             - padding - geo.halo)[None, :, None]
    out = []
    for dy, dx in _CORNERS:
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        inside = ((yi - win_y >= 0) & (yi - win_y < geo.window)
                  & (xi - win_x >= 0) & (xi - win_x < geo.window))
        out.append(torch.where(valid, torch.where(inside, 1, 2), 0))
    return torch.stack(out, -1).to(torch.int8)


def col2im_reductions(offset: torch.Tensor, c: int, h: int, w: int,
                      k: int = 3, stride: int = 1, padding: int = 1,
                      dilation: int = 1, vec: bool = True,
                      geometry: Optional[Col2imGeometry] = None,
                      row0: int = 0) -> dict:
    """Global reductions into grad_x per call, reckoned from the offsets and
    the kernel's geometry: 'scalar', one float per valid corner and channel
    (a kernel with one atomicAdd each); and the tiled kernel's
    'window_v4', at most one 16-byte reduction per 4 channels of each
    window pixel a listed corner reached (pixels whose sum is exactly 0
    are skipped), and 'fallback', one per 4 channels of each corner on the global path (per
    channel without 16-byte vectors, `vec` False): outside its window or
    beyond its pixel's full list.  'fallback_share' is their share of the
    valid corners."""
    b, _, ho, wo = offset.shape
    geo = geometry or col2im_geometry(k, stride, dilation)
    where = col2im_corners(offset, h, w, k, stride, padding, dilation, geo,
                           row0)
    valid = int((where > 0).sum())
    y0, x0 = _top_left_corners(offset, h, w, k, stride, padding, dilation,
                               row0)
    dev = offset.device
    tile = ((torch.arange(ho, device=dev) // geo.tile)[:, None]
            * _ceil(wo, geo.tile)
            + (torch.arange(wo, device=dev) // geo.tile)[None, :])
    tiles = _ceil(ho, geo.tile) * _ceil(wo, geo.tile)
    block = (torch.arange(b, device=dev)[:, None, None] * tiles
             + tile)[..., None]
    keys = torch.cat([(block * (h * w) + (y0 + dy) * w + x0 + dx)
                      [where[..., q] == 1]
                      for q, (dy, dx) in enumerate(_CORNERS)])
    _, counts = torch.unique(keys, return_counts=True)
    fallback = (int((where == 2).sum())
                + int((counts - geo.cap).clamp(min=0).sum()))
    return dict(scalar=valid * c, window_v4=int(counts.numel()) * _ceil(c, 4),
                fallback=fallback * (_ceil(c, 4) if vec else c),
                fallback_share=fallback / valid if valid else 0.0)


def col2im_vec(c: int, itemsize: int, *tensors: torch.Tensor) -> bool:
    """16-byte accesses hold for every channel vector: C a multiple of the
    vector and every pointer 16-byte aligned."""
    return (c % (16 // itemsize) == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch_col2im(g_cols, xh, offset, mask, dims):
    """The backward kernel on checked CUDA tensors (xh NHWC): (grad_xh NHWC
    in xh's dtype, grad_offset float32, grad_mask in xh's dtype)."""
    grad_x = torch.zeros(xh.shape, dtype=torch.float32, device=xh.device)
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    if g_cols.numel() == 0:
        return grad_x.to(xh.dtype), grad_offset.zero_(), grad_mask.zero_()
    vec = col2im_vec(dims[1], xh.element_size(), g_cols, xh, grad_x)
    lib = _build.load()
    global col2im_launches
    with _build.device_guard(xh.device):
        _build.check(lib.yolact_dcn_col2im(
            g_cols.data_ptr(), xh.data_ptr(), offset.data_ptr(),
            mask.data_ptr(), grad_x.data_ptr(), grad_offset.data_ptr(),
            grad_mask.data_ptr(), _DTYPE_CODES[xh.dtype], *dims, int(vec),
            _build.stream_ptr(xh.device)), 'yolact_dcn_col2im')
    col2im_launches += 1
    return grad_x.to(xh.dtype), grad_offset, grad_mask


def dcn_col2im_plain(g_cols: torch.Tensor, x: torch.Tensor,
                     offset: torch.Tensor, mask: torch.Tensor, k: int = 3,
                     stride: int = 1, padding: int = 1, dilation: int = 1,
                     row0: int = 0):
    """The gradients of :func:`dcn_columns_plain` for the columns' gradient
    `g_cols` [B*Ho*Wo, K*K*Cin]: (grad_x [B, Cin, H, W] in x's dtype,
    grad_offset, grad_mask in the mask's dtype), by ``torch.func.vjp``."""
    _, vjp = torch.func.vjp(
        lambda *t: dcn_columns_plain(*t, k, stride, padding, dilation, row0),
        x.detach(), offset.detach(), mask.detach())
    return vjp(g_cols.to(x.dtype))


def dcn_col2im(g_cols: torch.Tensor, x: torch.Tensor, offset: torch.Tensor,
               mask: torch.Tensor, k: int = 3, stride: int = 1,
               padding: int = 1, dilation: int = 1, row0: int = 0):
    """Same contract as :func:`dcn_col2im_plain`; the CUDA kernel for CUDA
    tensors (grad_x comes back as a channels_last view; its last bits
    change from run to run, see the module docstring)."""
    if x.device.type == 'cpu':
        return dcn_col2im_plain(g_cols, x, offset, mask, k, stride, padding,
                                dilation, row0)
    if x.device.type != 'cuda':
        raise ValueError(f'dcn_col2im: unsupported device {x.device}')
    xh, m, dims = _geometry(x, offset, mask, k, stride, padding, dilation,
                            row0)
    b, cin, _, _, ho, wo = dims[:6]
    if (tuple(g_cols.shape) != (b * ho * wo, k * k * cin)
            or g_cols.dtype != x.dtype or g_cols.device != x.device):
        raise ValueError(
            f'dcn_col2im: g_cols must be {(b * ho * wo, k * k * cin)} '
            f'{x.dtype} on {x.device}, got {tuple(g_cols.shape)} '
            f'{g_cols.dtype} on {g_cols.device}')
    gx, go, gm = _launch_col2im(g_cols.contiguous(), xh, offset, m, dims)
    return gx.permute(0, 3, 1, 2), go, gm.to(mask.dtype)


def _plain_dims(dims):
    """The plain versions' geometry arguments from the C entry points'."""
    return tuple(dims[6:])


@torch.library.custom_op('yolact_tpu_torch::dcn_columns', mutates_args=(),
                         device_types='cpu')
def dcn_columns_op(xh: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   dims: list[int]) -> torch.Tensor:
    """The sampling kernel as a custom op, on the NHWC x, the float32
    offsets, the mask in x's dtype and the launch geometry (the ints of
    the C entry point): the plain version on the CPU."""
    return dcn_columns_plain(xh.permute(0, 3, 1, 2), offset, mask,
                             *_plain_dims(dims))


@dcn_columns_op.register_kernel('cuda')
def _dcn_columns_cuda(xh, offset, mask, dims):
    return _launch_im2col(xh.contiguous(), offset.contiguous(),
                          mask.contiguous(), tuple(dims))


@dcn_columns_op.register_fake
def _dcn_columns_fake(xh, offset, mask, dims):
    b, cin, _, _, ho, wo, k = dims[:7]
    return xh.new_empty((b * ho * wo, k * k * cin))


@torch.library.custom_op('yolact_tpu_torch::dcn_col2im', mutates_args=(),
                         device_types='cpu')
def dcn_col2im_op(g_cols: torch.Tensor, xh: torch.Tensor,
                  offset: torch.Tensor, mask: torch.Tensor, dims: list[int]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel as a custom op, on the inputs of
    :func:`dcn_columns_op` and the columns' gradient: (grad_x NHWC in x's
    dtype, grad_offset float32, grad_mask in x's dtype), the plain version
    on the CPU."""
    gx, go, gm = dcn_col2im_plain(g_cols, xh.permute(0, 3, 1, 2), offset,
                                  mask, *_plain_dims(dims))
    return (gx.permute(0, 2, 3, 1).contiguous(), go.contiguous(),
            gm.contiguous())


@dcn_col2im_op.register_kernel('cuda')
def _dcn_col2im_cuda(g_cols, xh, offset, mask, dims):
    # looked up when the op runs: tests and chip_smoke.py record around it
    return _launch_col2im(g_cols.contiguous(), xh.contiguous(),
                          offset.contiguous(), mask.contiguous(), tuple(dims))


@dcn_col2im_op.register_fake
def _dcn_col2im_fake(g_cols, xh, offset, mask, dims):
    return (xh.new_empty(xh.shape), offset.new_empty(offset.shape),
            mask.new_empty(mask.shape))


def _dcn_columns_setup(ctx, inputs, output):
    xh, offset, mask, dims = inputs
    ctx.save_for_backward(xh, offset, mask)
    ctx.dims = dims


def _dcn_columns_backward(ctx, g_cols):
    xh, offset, mask = ctx.saved_tensors
    gx, go, gm = dcn_col2im_op(g_cols.contiguous(), xh, offset, mask,
                               ctx.dims)
    need = ctx.needs_input_grad
    return (gx if need[0] else None, go if need[1] else None,
            gm if need[2] else None, None)


dcn_columns_op.register_autograd(_dcn_columns_backward,
                                 setup_context=_dcn_columns_setup)


def dcn_columns(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                k: int = 3, stride: int = 1, padding: int = 1,
                dilation: int = 1, row0: int = 0) -> torch.Tensor:
    """Same contract as :func:`dcn_columns_plain`; the CUDA kernels for
    CUDA tensors, differentiable in x, offset and mask."""
    how = _build.route('dcn_columns', x.device, x, offset, mask)
    if how == 'plain':
        return dcn_columns_plain(x, offset, mask, k, stride, padding,
                                 dilation, row0)
    xh, m, dims = _geometry(x, offset, mask, k, stride, padding, dilation,
                            row0)
    if how == 'op':
        return dcn_columns_op(xh, offset, m, list(dims))
    return _launch_im2col(xh, offset, m, dims)


def _gemm(cols: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], b: int, ho: int,
          wo: int) -> torch.Tensor:
    """cols [B*Ho*Wo, K*K*Cin] @ weight [Cout, K*K*Cin]^T (float32
    accumulation, rounded to the columns' dtype), plus the bias: JAX's
    ``dot_general``.  Returns [B, Cout, Ho, Wo] as a channels_last view."""
    cout = weight.shape[0]
    w = weight.permute(0, 2, 3, 1).reshape(cout, -1).to(cols.dtype)
    out = torch.matmul(cols, w.t())
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.view(b, ho, wo, cout).permute(0, 3, 1, 2)


def deform_conv2d_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, stride: int = 1,
                        padding: int = 1, dilation: int = 1,
                        row0: int = 0) -> torch.Tensor:
    """DCNv2 forward -> [B, Cout, Ho, Wo] (channels_last) in x's dtype, all
    plain PyTorch; `row0`: see :func:`dcn_columns_plain`."""
    k = weight.shape[-1]
    cols = dcn_columns_plain(x, offset, mask, k, stride, padding, dilation,
                             row0)
    return _gemm(cols, weight, bias, x.shape[0], *offset.shape[-2:])


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 1, dilation: int = 1,
                  row0: int = 0) -> torch.Tensor:
    """Same contract as :func:`deform_conv2d_plain`; the columns come from
    the CUDA kernel for CUDA tensors."""
    k = weight.shape[-1]
    cols = dcn_columns(x, offset, mask, k, stride, padding, dilation, row0)
    return _gemm(cols, weight, bias, x.shape[0], *offset.shape[-2:])
