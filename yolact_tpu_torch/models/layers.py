"""Building blocks shared by the backbone and heads, NCHW.

Port of ``yolact_tpu/models/layers.py``.  Convolutions are plain
``nn.Conv2d`` with torch integer padding (the reference's own layer), and
parameter names follow the reference's ``state_dict``.

The space-to-depth ("s2d") stem helpers are ported with JAX's channel
contract: a 2x2 space-to-depth input has channel ``(p*2+q)*3 + c`` for the
pixel at row offset ``p`` and column offset ``q`` of each 2x2 cell, ``c``
in raw BGR order, and the 7x7/s2/p3 stem conv becomes a 4x4/s1 conv with
padding (2, 1) over it (:func:`s2d_stem_kernel`, ``kernels/stem.py``).  The
rearrangement is a reshape and permute; JAX's one-hot stride-2 conv, which
makes the TPU's matrix unit do the shuffle, is not ported.  The s2d stem
runs only where a config asks for it (``cfg.stem_s2d``).

Compute dtype follows the JAX convention (flax modules with ``dtype`` over
float32 parameters): :class:`Conv2d` and :class:`Linear` compute in their
input's dtype and cast their weight and bias to it at use, so a bfloat16
activation runs a bfloat16 conv over float32 master weights, and autograd
brings float32 gradients back to them.  For inference
``Yolact.set_compute_dtype`` casts the weights once, and the cast at use is
then a no-op.  Batch norm keeps float32 statistics and parameters.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolact_tpu_torch.parallel.mesh import Rows, fetch_rows


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: weight and bias are cast to it at
    use (see the module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype, as :class:`Conv2d`.
    JAX's ``layers.py:ConvTranspose`` is flax's transposed conv with
    ``transpose_kernel=True`` and padding ``k - 1 - p`` over the dilated
    input, which is torch's output size and arithmetic for any kernel,
    stride and padding without ``output_padding``
    (``tests/test_torch_options.py`` holds k = s = 2, p = 0 and stride-1
    cases)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype, as :class:`Conv2d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def s2d_stem_kernel(w: torch.Tensor) -> torch.Tensor:
    """A 7x7/s2/p3 stem weight ``[O, C, 7, 7]`` (RGB input order) as the
    equivalent 4x4/s1 weight ``[O, 4*C, 4, 4]`` over a 2x2 space-to-depth
    input in raw (BGR) order, channel ``(p*2+q)*C + c`` (JAX
    ``s2d_stem_kernel`` in OIHW).  Output tap ``a = 2m + p - 1`` covers the
    7 taps for ``m`` in [0, 4), ``p`` in {0, 1}; the tap at -1 is zero.
    Exact: only a flip, a zero pad and a rearrangement."""
    o, c, kh, kw = w.shape
    if (kh, kw) != (7, 7):
        raise NotImplementedError('s2d stem assumes a 7x7/s2/p3 conv')
    wp = F.pad(w.flip(1), (1, 0, 1, 0))           # fold BGR->RGB; a+1 >= 0
    wp = wp.view(o, c, 4, 2, 4, 2)                # [o, c, m, p, n, q]
    return wp.permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * c, 4, 4)


def s2d_input(x: torch.Tensor, from_rgb: bool = False) -> torch.Tensor:
    """``[B, C, H, W]`` -> 2x2 space-to-depth ``[B, 4*C, H/2, W/2]`` with
    channel ``(p*2+q)*C + c`` (JAX ``s2d_input`` / ``s2d_eye_kernel``).
    ``from_rgb`` reverses the channels first, so an RGB input lands in raw
    (BGR) order, the stem conv's contract."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError('s2d input needs even H and W')
    if from_rgb:
        x = x.flip(1)
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)      # [b, c, h, p, w, q]
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def mesh_moments(mesh, x: torch.Tensor, dims: Tuple[int, ...]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean and biased variance of `x` over `dims` and over the ranks
    of `mesh`, differentiable, the same bits on every rank: each rank's
    (count, mean, sum of squared deviations) goes to every rank in one
    differentiable all-reduce (each rank fills its own slot of a zero
    buffer, so the sum is an exact gather), and each combines them in rank
    order (Chan's pairwise rule), their gradient flowing back to every
    rank's `x`.  A rank whose `x` is empty (it owns no row of a split map)
    adds a count of 0, its zeros still in the graph, so that its backward
    issues the all-reduce too."""
    count = int(np.prod([x.shape[d] for d in dims]))
    if count:
        mean = x.mean(dim=dims, keepdim=True)
        m2 = (x - mean).square().sum(dim=dims)
        mean = mean.squeeze(dims)
    else:
        mean = m2 = x.sum(dim=dims)
    local = torch.stack([torch.full_like(mean, count), mean, m2])[None]
    parts = mesh.all_sum_grad(F.pad(
        local, (0, 0) * (local.dim() - 1)
        + (mesh.rank, mesh.size - 1 - mesh.rank)))
    counts, means, m2s = parts.unbind(1)        # [ranks, ...] each
    total = counts.sum(0)
    mean = (counts * means).sum(0) / total
    var = (m2s + counts * (means - mean).square()).sum(0) / total
    return mean, var


class BatchNorm2d(nn.Module):
    """Batch norm (eps 1e-5) with the reference's parameter names.
    Statistics stay float32 whatever the input dtype; the output has the
    input's dtype.

    ``train=False`` normalises with the running statistics.  ``train=True``
    (JAX ``BatchNorm(train=True)``) normalises with the batch's and works
    out the next running statistics, ``0.9 * running + 0.1 * batch`` (torch
    momentum 0.1), with the BIASED batch variance as flax stores it
    (``F.batch_norm`` would store the unbiased one).  As flax returns the new
    ``batch_stats`` beside the output instead of writing them, the forward
    leaves them in ``pending``: :func:`commit_batch_stats` writes them to the
    buffers.  So a step that turns out non-finite can drop them, and a
    block replayed by activation checkpointing, which computes the same
    pending values again, does not move the running statistics twice.

    ``shared``: the layer runs more than once per forward (the prediction
    head shared by every level, which activation checkpointing never
    replays); each call then starts from the statistics the call before it
    left, as the reference's in-place update and flax's do.

    ``mesh`` (a ``parallel/mesh.py:Mesh`` of more than one rank, set by
    ``train/step.py:create_train_state``): each rank holds its rows of the
    global batch, and ``train=True`` normalises with the GLOBAL batch's
    moments (:func:`mesh_moments`), as JAX's sharded step does.  Under a
    spatial split (``parallel/mesh.py:make_mesh_2d``) every rank holds
    some rows of its data rank's images, and the same rule over every rank
    gives the moments over the global N x H x W."""

    momentum = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.shared = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.pending = None     # (running_mean, running_var) after this batch
        self.mesh = None

    def forward(self, x: torch.Tensor, train: bool = False,
                rows: Optional[Rows] = None) -> torch.Tensor:
        """`rows` (the map's, under a spatial split) is unused: batch norm
        takes its ranks from ``mesh``."""
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.mesh is not None and self.mesh.size > 1:
            return self._global_batch_norm(x)
        # momentum 1 leaves exactly the batch mean and its unbiased variance
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                           self.eps)
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            start = self.pending if self.shared and self.pending else \
                (self.running_mean, self.running_var)
            self.pending = (
                torch.lerp(start[0], mean, self.momentum),
                torch.lerp(start[1], var * ((n - 1) / n), self.momentum))
        return out

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """``train=True`` over the ranks' rows together (see the class
        docstring); the pending statistics as the one-device forward leaves
        them for the global batch."""
        xf = x.float()
        mean, var = mesh_moments(self.mesh, xf, (0, 2, 3))
        scale = self.weight * torch.rsqrt(var + self.eps)
        out = (xf - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]
        with torch.no_grad():
            start = self.pending if self.shared and self.pending else \
                (self.running_mean, self.running_var)
            self.pending = (torch.lerp(start[0], mean, self.momentum),
                            torch.lerp(start[1], var, self.momentum))
        return out.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """Group norm (32 groups, eps 1e-5) behind the batch-norm call
    signature ``(x, train, rows)``, whose ``train`` it ignores: it holds no
    running statistics (JAX ``layers.py:GroupNorm``).  As flax's, it
    computes in float32 (float64 for a float64 input) and returns the
    input's dtype.

    ``rows`` (a spatial split, ``parallel/mesh.py``): `x` is a rank's rows
    of its data rank's images, and the moments of each image's group span
    the whole height: :func:`mesh_moments` per ``[N, G]`` over the SPACE
    group only (the data ranks hold other images).  Having no running
    statistics, group norm takes this collective in inference too."""

    def __init__(self, num_channels: int, num_groups: int = 32):
        super().__init__(num_groups, num_channels, eps=1e-5)

    def forward(self, x: torch.Tensor, train: bool = False,
                rows: Optional[Rows] = None) -> torch.Tensor:
        wide = x.to(torch.promote_types(x.dtype, torch.float32))
        if rows is None or rows.space.size == 1:
            return F.group_norm(wide, self.num_groups, self.weight,
                                self.bias, self.eps).to(x.dtype)
        b, c, n, w = x.shape
        g = self.num_groups
        xg = wide.reshape(b, g, (c // g) * n * w)
        mean, var = mesh_moments(rows.space, xg, (2,))
        out = ((xg - mean[..., None]) * torch.rsqrt(var + self.eps)[..., None]
               ).reshape(b, c, n, w)
        out = out * self.weight[:, None, None] + self.bias[:, None, None]
        return out.to(x.dtype)


def commit_batch_stats(model: nn.Module) -> int:
    """Write every batch norm's pending running statistics (left by a
    ``train=True`` forward) to its buffers and clear them; returns how many
    layers had some."""
    n = 0
    for m in model.modules():
        if isinstance(m, BatchNorm2d) and m.pending is not None:
            m.running_mean.copy_(m.pending[0])
            m.running_var.copy_(m.pending[1])
            m.pending = None
            n += 1
    return n


def drop_batch_stats(model: nn.Module) -> None:
    """Forget the pending running statistics (a step that is skipped)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.pending = None


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """torch-style max pool (pads with -inf; floor or ceil output size,
    :func:`pool_out_size`).
    JAX's version pads the right edge for ``ceil_mode``, which keeps a last
    window starting in the right padding that torch drops; the two agree
    where ``ceil_mode`` is off or ``padding`` is 0 (every pool of the
    configs)."""
    return F.max_pool2d(x, kernel, stride, padding, ceil_mode=ceil_mode)


class InterpolateModule(nn.Module):
    """Bilinear scale-by-factor layer (half-pixel centers)."""

    def __init__(self, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = (x.shape[2] * self.scale_factor, x.shape[3] * self.scale_factor)
        return F.interpolate(x, size=size, mode='bilinear',
                             align_corners=False)


# ---- row-sharded ops (spatial split, ``parallel/mesh.py``) ----------------
#
# Each takes this rank's rows of a map and the map's ``Rows`` and returns
# this rank's rows of the output and the output's ``Rows``: it fetches the
# global input rows that its output rows need (:func:`fetch_rows`, zeros or
# -inf outside the map, as the whole-map op pads) and runs the op with no
# padding along the height.  A rank that owns no output row computes one
# row at its position and keeps none of it, so every rank issues the same
# collectives and its (empty) output stays in the graph.  With ``rows``
# None (no split) each runs the whole-map op and returns None for the
# rows, so a module's wiring is written once for both.


def height(x: torch.Tensor, rows: Optional[Rows]) -> int:
    """The global height of the map whose rows `x` holds."""
    return x.shape[2] if rows is None else rows.height


def out_size(size: int, k: int, stride: int, padding: int,
             dilation: int = 1) -> int:
    """A conv's or pool's output length along one axis."""
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def _windows(out: Rows, k: int, stride: int, padding: int,
             dilation: int = 1) -> List[Tuple[int, int]]:
    """Every rank's input rows for its output rows of `out` (one row for
    a rank that owns none)."""
    span = dilation * (k - 1) + 1
    return [(o0 * stride - padding,
             (max(o1, o0 + 1) - 1) * stride - padding + span)
            for o0, o1 in out.owns()]


def _kept(y: torch.Tensor, out: Rows) -> torch.Tensor:
    lo, hi = out.own()
    return y if hi > lo else y[:, :, :0]


def conv_rows(conv: nn.Conv2d, x: torch.Tensor,
              rows: Optional[Rows]) -> Tuple[torch.Tensor, Optional[Rows]]:
    """`conv` (a zero-padded :class:`Conv2d`, computing in x's dtype) on
    the row-sharded `x`."""
    if rows is None:
        return conv(x), None
    (k, _), (s, _), (p, pw), (d, _) = (conv.kernel_size, conv.stride,
                                       conv.padding, conv.dilation)
    out = rows.at(out_size(rows.height, k, s, p, d))
    xw = fetch_rows(x, rows, _windows(out, k, s, p, d))
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(xw, conv.weight.to(x.dtype), bias, conv.stride, (0, pw),
                 conv.dilation, conv.groups)
    return _kept(y, out), out


def pool_out_size(size: int, k: int, stride: int, padding: int,
                  ceil_mode: bool = False) -> int:
    """A max pool's output length along one axis, torch's rule: in ceil
    mode a last window must still start inside the input or its left
    padding."""
    if not ceil_mode:
        return out_size(size, k, stride, padding)
    n = -(-(size + 2 * padding - k) // stride) + 1
    return n - 1 if (n - 1) * stride >= size + padding else n


def max_pool_rows(x: torch.Tensor, rows: Optional[Rows], kernel: int,
                  stride: int, padding: int = 0, ceil_mode: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Rows]]:
    """:func:`max_pool` (floor or ceil mode) on the row-sharded `x`: rows
    of a window beyond the map, a ceil-mode last window's too, come back
    -inf from the fetch, as the whole-map pool pads."""
    if rows is None:
        return max_pool(x, kernel, stride, padding, ceil_mode), None
    out = rows.at(pool_out_size(rows.height, kernel, stride, padding,
                                ceil_mode))
    xw = fetch_rows(x, rows, _windows(out, kernel, stride, padding),
                    fill=-float('inf'))
    # the window holds exactly the output rows' taps: either mode gives
    # their count along the height, and the width keeps the whole map's
    y = F.max_pool2d(xw, kernel, stride, (0, padding), ceil_mode=ceil_mode)
    return _kept(y, out), out


def conv_transpose_rows(conv: nn.ConvTranspose2d, x: torch.Tensor,
                        rows: Optional[Rows]
                        ) -> Tuple[torch.Tensor, Optional[Rows]]:
    """`conv` (a :class:`ConvTranspose2d`, computing in x's dtype) on the
    row-sharded `x`.  Output row o takes input row i through tap t where
    ``o = i s - p + t d``, so output rows ``[o0, o1)`` need input rows
    ``[ceil((o0 + p - d (k - 1)) / s), floor((o1 - 1 + p) / s) + 1)``
    (zeros outside the map).  The fetched rows go through the transposed
    conv without height padding, whose row j is global row
    ``i0 s - p + j``; the rank's rows are cut from it (zero rows where
    no input reaches, the ``output_padding`` rows among them) and take the
    bias after."""
    if rows is None:
        return conv(x), None
    (k, _), (s, _), (p, pw), (op, opw), (d, _) = (
        conv.kernel_size, conv.stride, conv.padding, conv.output_padding,
        conv.dilation)
    span = d * (k - 1) + 1
    out = rows.at((rows.height - 1) * s - 2 * p + span + op)
    wins = []
    for o0, o1 in out.owns():
        i0 = -(-(o0 + p - span + 1) // s)
        wins.append((i0, max((max(o1, o0 + 1) - 1 + p) // s + 1, i0 + 1)))
    xw = fetch_rows(x, rows, wins)
    y = F.conv_transpose2d(xw, conv.weight.to(x.dtype), None, conv.stride,
                           (0, pw), (0, opw), conv.groups, conv.dilation)
    o0, o1 = out.own()
    top = o0 + p - wins[rows.space.rank][0] * s
    m = max(o1, o0 + 1) - o0
    y = F.pad(y, (0, 0, -top, top + m - y.shape[2]))
    if conv.bias is not None:
        y = y + conv.bias.to(x.dtype)[:, None, None]
    return _kept(y, out), out


def _source_rows(n_in: int, n_out: int, mode: str):
    """Per output row of a resize from `n_in` to `n_out` rows: the first
    and second source rows and the second's weight (bilinear, half-pixel
    centers, as ``F.interpolate(align_corners=False)``), or the source row
    of 'nearest' (``floor(o * n_in / n_out)``) with weight 0."""
    o = np.arange(n_out)
    scale = n_in / n_out
    if mode == 'nearest':
        i0 = np.minimum(np.floor(o * scale).astype(np.int64), n_in - 1)
        return i0, i0, np.zeros(n_out)
    src = np.maximum((o + 0.5) * scale - 0.5, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), src - i0


def resize_rows(x: torch.Tensor, rows: Optional[Rows],
                size: Tuple[int, int], mode: str = 'bilinear'
                ) -> Tuple[torch.Tensor, Optional[Rows]]:
    """``F.interpolate(x, size, mode)`` (bilinear without corner alignment,
    or nearest: torch's 'nearest' picks source ``floor(dst * in / out)``,
    as the JAX package reproduces) on the row-sharded `x`: the width by
    ``F.interpolate`` at an unchanged height (the identity along it), then
    the height from the fetched source rows."""
    if mode not in ('bilinear', 'nearest'):
        raise NotImplementedError(f'resize mode {mode!r}')
    kw = {'align_corners': False} if mode == 'bilinear' else {}
    if rows is None:
        return F.interpolate(x, size=tuple(size), mode=mode, **kw), None
    out = rows.at(size[0])
    i0, i1, lam = _source_rows(rows.height, size[0], mode)
    wins = [(int(i0[o0]), int(i1[max(o1, o0 + 1) - 1]) + 1)
            for o0, o1 in out.owns()]
    xw = fetch_rows(x, rows, wins)
    xw = F.interpolate(xw, size=(xw.shape[2], size[1]), mode=mode, **kw)
    o0, o1 = out.own()
    sel = slice(o0, max(o1, o0 + 1))
    lo = wins[rows.space.rank][0]
    dev = x.device
    a = xw.index_select(2, torch.as_tensor(i0[sel] - lo, device=dev))
    if mode == 'nearest':
        y = a
    else:
        b = xw.index_select(2, torch.as_tensor(i1[sel] - lo, device=dev))
        w1 = torch.as_tensor(lam[sel], dtype=x.dtype, device=dev)[:, None]
        y = a * (1 - w1) + b * w1
    return _kept(y, out), out


def run_rows(net: nn.Sequential, x: torch.Tensor, rows: Optional[Rows]
             ) -> Tuple[torch.Tensor, Optional[Rows]]:
    """A :func:`make_net` net's or a VGG group's layers in turn on the
    row-sharded `x`: convs, transposed convs, max pools, bilinear
    upsamples, (leaky) ReLUs and ``'cat'`` entries, whose sub-nets run on
    the same rows."""
    for layer in net:
        if rows is None or isinstance(layer, (nn.ReLU, nn.LeakyReLU)):
            x = layer(x)
        elif isinstance(layer, InterpolateModule):
            f = layer.scale_factor
            x, rows = resize_rows(x, rows, (rows.height * f, x.shape[3] * f))
        elif isinstance(layer, nn.ConvTranspose2d):
            x, rows = conv_transpose_rows(layer, x, rows)
        elif isinstance(layer, nn.Conv2d):
            x, rows = conv_rows(layer, x, rows)
        elif isinstance(layer, nn.MaxPool2d):
            x, rows = max_pool_rows(x, rows, layer.kernel_size, layer.stride,
                                    layer.padding, layer.ceil_mode)
        elif isinstance(layer, Concat):
            parts = [run_rows(sub, x, rows) for sub in layer.nets]
            assert all(r == parts[0][1] for _, r in parts), \
                "a 'cat' entry's sub-nets leave maps of different heights"
            x, rows = torch.cat([y for y, _ in parts], dim=1), parts[0][1]
        else:
            raise TypeError(f'run_rows: no row-sharded '
                            f'{type(layer).__name__}')
    return x, rows


class Concat(nn.Module):
    """make_net's ``'cat'`` entry: parallel sub-nets over the same input,
    concatenated on channels (the reference's ``Concat``, its sub-nets
    under ``nets.{j}``; JAX's ``SpecNet`` names them
    ``layers_{i}_cat_{j}``)."""

    def __init__(self, nets):
        super().__init__()
        self.nets = nn.ModuleList(nets)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([net(x) for net in self.nets], dim=1)


def make_net(in_channels: int, spec: Tuple[Tuple[Any, ...], ...],
             include_last_relu: bool = True) -> Tuple[nn.Sequential, int]:
    """Build a make_net layer spec as an ``nn.Sequential`` with a ReLU slot
    after every entry, so index ``i`` is the JAX ``layers_{i}`` and the
    reference's ``state_dict`` index.  Returns (net, out_channels).

    Entries are ``(channels, kernel, kwargs)``: a conv for kernel > 0, a
    transposed conv of kernel ``-kernel`` (stride 1 unless kwargs say, as
    torch's default) for kernel < 0, a bilinear upsample by ``-kernel`` for
    channels None, and ``('cat', (spec, ...))``: the sub-specs side by side
    (:class:`Concat`), each with its last ReLU."""
    layers = []
    ch = in_channels
    for entry in spec:
        num, k = entry[0], entry[1]
        kw = dict(entry[2]) if len(entry) > 2 else {}
        if isinstance(num, str):
            if num != 'cat':
                raise ValueError(f'make_net entry {entry!r}: unknown {num!r}')
            nets = [make_net(ch, sub, include_last_relu=True) for sub in k]
            layers.append(Concat([net for net, _ in nets]))
            ch = sum(c for _, c in nets)
        elif k > 0:
            layers.append(Conv2d(ch, num, k, stride=kw.get('stride', 1),
                                 padding=kw.get('padding', 0),
                                 dilation=kw.get('dilation', 1)))
            ch = num
        elif num is None:
            layers.append(InterpolateModule(-k))
        else:
            layers.append(ConvTranspose2d(ch, num, -k,
                                          stride=kw.get('stride', 1),
                                          padding=kw.get('padding', 0)))
            ch = num
        layers.append(nn.ReLU())
    if not include_last_relu and layers:
        layers = layers[:-1]
    return nn.Sequential(*layers), ch
