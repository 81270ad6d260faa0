"""Data parallelism and spatial partitioning over ``torch.distributed``.
Port of ``yolact_tpu/parallel/mesh.py``.

The JAX package shards the batch over a 1-D ``jax.sharding.Mesh`` and lets
XLA insert the all-reduces that make the sharded step the one-device step
on the global batch.  Here every rank is a process that owns one device and
its rows of the global batch (:func:`shard_batch`), and the train step
calls the collectives itself where the math reduces over the batch: the
batch-norm moments (``models/layers.py``), the loss's normalisers, OHEM's
stabiliser, the class-balanced counts and the mask-IoU cap
(``train/loss.py``), the gradients, the finite guard and the returned
losses (``train/step.py``).  A :class:`Mesh` of one rank runs none of them.

The process group starts from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``;
:func:`init_from_env`, which returns this rank's :class:`Mesh`), which
takes the place of ``jax.distributed.initialize`` and JAX's
``make_mesh``.  The caller names the backend: NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU, or gloo on a card the caller names
(ranks that share one card: NCCL refuses two ranks on one device).  A
missing card or a failing init raises; nothing falls back to another
backend or to the CPU.

Spatial partitioning (JAX's ``make_mesh_2d``): :func:`make_mesh_2d` splits the W ranks into a grid of D = W / S data
ranks by S space ranks (world rank ``d * S + s``, as JAX reshapes its
devices to ``(data, space)``), with a process group for each data rank's
space ranks and one for each space index's data ranks.  A data rank's
images are split by height over its space ranks: every map of global
height H is held as rows ``[floor(s H / S), floor((s + 1) H / S))`` by
space rank s (:func:`own`; a rank may own no row of a small map), which
:class:`Rows` describes.  Where XLA's SPMD partitioner inserts the halo
exchanges, the port calls them itself: :func:`fetch_rows` gives each rank
the global rows an op needs (its output rows' window, with a fill value
outside the map), and :func:`gather_rows` gives every rank the whole
height, with one of two gradients: 'own' (the gathered map feeds this
rank's own rows only, so every rank's gradient of it is summed into the
owner's rows) or 'shared' (every rank consumes the gathered map alike, as
the loss and the detection do, so each rank keeps its own rows' gradient).
Every rank issues the same collectives in the same order, whatever rows it
owns.  JAX's ``shard_batch_spatial`` has no counterpart: a rank takes its
data rank's images (:func:`shard_batch` over the ``data`` mesh, as the
loader does), and the model's input rows are cut once, where the train
step and the inference take them (:meth:`Rows.take`), after the device
augmentation has run on the whole images.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

BACKENDS = ('nccl', 'gloo')


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a group of ranks: its ``rank`` of ``size`` and
    the ``device`` its rows and replica live on.  ``group`` is the process
    group (None: the default group of every rank).  A mesh from
    :func:`make_mesh_2d` also holds this rank's ``data`` mesh (the ranks at
    its space index, one per data rank) and ``space`` mesh (its data
    rank's ranks, one per space rank)."""
    rank: int
    size: int
    device: torch.device
    group: Any = None
    data: Optional['Mesh'] = None
    space: Optional['Mesh'] = None

    @property
    def spatial(self) -> bool:
        """The image height is split over more than one rank."""
        return self.space is not None and self.space.size > 1

    @property
    def data_mesh(self) -> 'Mesh':
        """The ranks that hold different images: `data` under a spatial
        split, else this mesh."""
        return self.data if self.data is not None else self

    def rows(self, n: int) -> slice:
        """This rank's rows of a global dimension of `n`."""
        if n % self.size:
            raise ValueError(f'{n} rows do not divide over {self.size} ranks')
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    # ---- collectives (on this mesh's group) -----------------------------

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of `t` (no gradient), a new tensor."""
        out = t.detach().clone()
        if self.size > 1:
            dist.all_reduce(out, group=self.group)
        return out

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over ranks of float `t` (no gradient), NaN
        where any rank's is NaN, as ``torch.max`` over the whole batch
        gives (the backends' MAX drops NaNs)."""
        if self.size == 1:
            return t.detach().clone()
        nan = t.detach().isnan()
        both = torch.stack([t.detach().masked_fill(nan, -float('inf')),
                            nan.to(t.dtype)])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        return both[0].masked_fill(both[1] > 0, float('nan'))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` concatenated along dim 0 in rank order (no
        gradient; bool tensors travel as uint8)."""
        if self.size == 1:
            return t.detach().clone()
        src = t.detach().to(torch.uint8) if t.dtype == torch.bool \
            else t.detach()
        return torch.cat(_all_gather(src, self.group, self.size)).to(t.dtype)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """This mesh's rank 0's `t` on every rank (one shape and dtype on
        every rank; no gradient), a new contiguous tensor."""
        out = t.detach().clone(memory_format=torch.contiguous_format)
        if self.size > 1:
            src = 0 if self.group is None else \
                dist.get_global_rank(self.group, 0)
            wire = out.view(torch.uint8) if out.dtype == torch.bool \
                else _wire(out)
            dist.broadcast(wire, src, group=self.group)
        return out

    def all_sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of `t`, differentiable: the gradient of each
        rank's input is the sum over ranks of the output's gradients."""
        if self.size == 1:
            return t
        return _AllSum.apply(t, self.group)

    def all_sum_grads(self, params: Sequence[torch.nn.Parameter]) -> None:
        """Replace each parameter's ``.grad`` by its sum over ranks, in one
        collective over a flat buffer.  Every rank runs the same graph, so
        the same parameters have a gradient on every rank."""
        params = [p for p in params if p.grad is not None]
        if self.size == 1 or not params:
            return
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat, group=self.group)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def all_true(self, flag: bool) -> bool:
        """Whether `flag` holds on every rank."""
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([0.0 if flag else 1.0], device=self.device)
        dist.all_reduce(t, group=self.group)
        return float(t) == 0.0

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """`t` (contiguous) as the backends carry it: a 2-byte float travels
    as its bytes (gloo takes no 16-bit integer, and not every build takes
    bfloat16)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.uint8)
    return t


def _all_gather(t: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    """Every rank's `t` (one shape on every rank), in rank order."""
    src = _wire(t.contiguous())
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return [p.view(t.dtype) for p in parts]


def _all_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group`'s ranks of `t`, in place where `t` is float32
    or float64 (a bfloat16 sum is taken in float32); returns it."""
    if t.dtype in (torch.float32, torch.float64):
        dist.all_reduce(t, group=group)
        return t
    wide = t.float()
    dist.all_reduce(wide, group=group)
    return t.copy_(wide)


class _AllSum(torch.autograd.Function):
    """The sum over ranks, whose gradient is the sum over ranks of the
    output's gradients (every rank's output depends on every input)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


# ---- spatial partitioning ---------------------------------------------------

def own(n: int, rank: int, size: int) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of a map of height `n` that space rank `rank`
    of `size` owns: ``[floor(rank n / size), floor((rank + 1) n / size))``
    (possibly empty)."""
    return rank * n // size, (rank + 1) * n // size


@dataclasses.dataclass(frozen=True)
class Rows:
    """A row-sharded map: the `space` mesh whose ranks hold its rows, and
    its global `height`.  Rank s holds rows ``own(height, s, S)``."""
    space: Mesh
    height: int

    def own(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """The rows of `rank` (default: this rank)."""
        return own(self.height, self.space.rank if rank is None else rank,
                   self.space.size)

    def owns(self) -> List[Tuple[int, int]]:
        """Every rank's rows, in rank order."""
        return [self.own(r) for r in range(self.space.size)]

    def at(self, height: int) -> 'Rows':
        """The same ranks holding a map of another height."""
        return Rows(self.space, height)

    def take(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This rank's rows of a whole map `x` (height on `dim`)."""
        if x.shape[dim] != self.height:
            raise ValueError(f'a map of height {x.shape[dim]} is not the '
                             f'{self.height} rows these Rows describe')
        lo, hi = self.own()
        return x.narrow(dim, lo, hi - lo)


def _halo(rows: Rows, windows: Sequence[Tuple[int, int]]) -> int:
    """The most rows any rank's window reaches beyond its own rows inside
    the map: each rank sends its first and last so many rows (fewer where
    it owns fewer), which hold every row another rank's window needs (a
    row within h of a rank's boundary is within h of its owner's)."""
    h = 0
    for (a, b), (lo, hi) in zip(rows.owns(), windows):
        lo, hi = max(lo, 0), min(hi, rows.height)
        if hi > lo:
            h = max(h, a - lo, hi - b)
    return h


class _FetchRows(torch.autograd.Function):
    """See :func:`fetch_rows`.  Forward: one all-gather of every rank's
    first and last `halo` rows (zero-padded to `halo` each); the window is
    the fill rows outside the map, the gathered rows above this rank's,
    its own rows in the window, and the gathered rows below.  Backward:
    the gradients of the gathered rows of every rank are summed (one
    all-reduce) and each rank adds its slabs' share into its first and
    last rows."""

    @staticmethod
    def forward(ctx, x, rows, window, fill, halo):
        space = rows.space
        b, c, n, w = x.shape
        lo, hi = window
        a0 = rows.own()[0]
        in_lo = max(lo, 0)
        in_hi = max(min(hi, rows.height), in_lo)
        # this rank's rows of the window [m0, m1), the rows above and below
        m0 = min(max(in_lo, a0), in_hi)
        m1 = max(min(in_hi, a0 + n), m0)
        above, below = list(range(in_lo, m0)), list(range(m1, in_hi))
        start = min(max(m0 - a0, 0), n)
        parts = [x.new_full((b, c, in_lo - lo, w), fill)]
        idx = None
        if halo > 0:
            t = min(halo, n)
            slab = x.new_zeros((b, c, 2 * halo, w))
            slab[:, :, :t] = x[:, :, :t]
            slab[:, :, halo:halo + t] = x[:, :, n - t:]
            slabs = torch.cat(_all_gather(slab, space.group, space.size), 2)
            owns = rows.owns()
            index = []
            for g in above + below:
                r = next(r for r, (ra, rb) in enumerate(owns) if ra <= g < rb)
                ra, rb = owns[r]
                t = min(halo, rb - ra)
                index.append(2 * halo * r + (g - ra if g - ra < t
                                             else halo + g - (rb - t)))
            idx = torch.tensor(index, dtype=torch.long, device=x.device)
            fetched = slabs.index_select(2, idx)
            parts += [fetched[:, :, :len(above)],
                      x[:, :, start:start + m1 - m0],
                      fetched[:, :, len(above):]]
        else:
            parts.append(x[:, :, start:start + m1 - m0])
        parts.append(x.new_full((b, c, hi - in_hi, w), fill))
        ctx.meta = (rows, n, halo, idx, (in_lo - lo, len(above), m1 - m0,
                                         len(below), hi - in_hi), start)
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        rows, n, halo, idx, sizes, start = ctx.meta
        _, g_above, g_mine, g_below, _ = g.split(sizes, dim=2)
        b, c, _, w = g.shape
        gx = g.new_zeros((b, c, n, w))
        gx[:, :, start:start + sizes[2]] = g_mine
        if halo > 0:
            space = rows.space
            gs = g.new_zeros((b, c, 2 * halo * space.size, w))
            gs.index_copy_(2, idx, torch.cat([g_above, g_below], 2))
            gs = _all_sum_(gs, space.group)
            r = space.rank
            t = min(halo, n)
            gx[:, :, :t] += gs[:, :, 2 * halo * r:2 * halo * r + t]
            gx[:, :, n - t:] += gs[:, :, 2 * halo * r + halo:
                                   2 * halo * r + halo + t]
        return gx, None, None, None, None


def fetch_rows(x: torch.Tensor, rows: Rows,
               windows: Sequence[Tuple[int, int]],
               fill: float = 0.0) -> torch.Tensor:
    """The global rows ``windows[rank]`` = ``[lo, hi)`` of the row-sharded
    map `x` ``[B, C, n, W]`` (this rank's rows of `rows`), `fill` where a
    row lies outside ``[0, height)``; differentiable (each fetched row's
    gradient is added into its owner's row).  `windows` holds every rank's
    window, in rank order: every rank must pass the same list."""
    if len(windows) != rows.space.size:
        raise ValueError(f'{len(windows)} windows for {rows.space.size} '
                         f'ranks')
    lo, hi = rows.own()
    if x.shape[2] != hi - lo:
        raise ValueError(f'rank {rows.space.rank} holds rows [{lo}, {hi}) of '
                         f'{rows.height}, not {x.shape[2]}')
    window = tuple(windows[rows.space.rank])
    halo = _halo(rows, windows) if rows.space.size > 1 else 0
    if halo == 0 and window == (lo, hi):
        return x
    return _FetchRows.apply(x, rows, window, float(fill), halo)


class _GatherRows(torch.autograd.Function):
    """See :func:`gather_rows`."""

    @staticmethod
    def forward(ctx, x, rows, shared):
        space = rows.space
        owns = rows.owns()
        most = max(hi - lo for lo, hi in owns)
        b, c, n, w = x.shape
        pad = x.new_zeros((b, c, most, w))
        pad[:, :, :n] = x
        parts = _all_gather(pad, space.group, space.size)
        ctx.meta = (rows, shared)
        return torch.cat([p[:, :, :hi - lo] for p, (lo, hi)
                          in zip(parts, owns)], dim=2)

    @staticmethod
    def backward(ctx, g):
        rows, shared = ctx.meta
        if not shared:
            g = _all_sum_(g.contiguous().clone(), rows.space.group)
        lo, hi = rows.own()
        return g[:, :, lo:hi].contiguous(), None, None


def gather_rows(x: torch.Tensor, rows: Optional[Rows],
                grad: str) -> torch.Tensor:
    """The whole height of the row-sharded map `x` on every rank,
    differentiable.  `grad` says how the gathered map is consumed:
    'own' (by this rank's own rows, e.g. the DCN input, whose samples can
    lie anywhere): each rank's rows get the sum over ranks of the
    gradient; 'shared' (identically by every rank, e.g. the head outputs
    before the loss): each rank's rows get their slice of its own
    gradient.  Taking one for the other scales a gradient by S or 1/S.
    `rows` None: `x` is the whole map already."""
    if grad not in ('own', 'shared'):
        raise ValueError(f"gather_rows: grad={grad!r}: 'own' or 'shared'")
    if rows is None or rows.space.size == 1:
        return x
    return _GatherRows.apply(x, rows, grad == 'shared')


def _device_for(backend: str, local_rank: int,
                device: Union[str, torch.device, None]) -> torch.device:
    if backend not in BACKENDS:
        raise ValueError(f'backend {backend!r}: expected one of {BACKENDS}')
    if device is None:
        device = f'cuda:{local_rank}' if backend == 'nccl' else 'cpu'
    device = torch.device(device)
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError(f'NCCL runs on CUDA devices, not {device}')
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'{backend} on {device} requested but '
                               f'torch.cuda.is_available() is False')
        index = local_rank if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f'{device} requested but only '
                               f'{torch.cuda.device_count()} CUDA devices '
                               f'are present')
        device = torch.device('cuda', index)
        torch.cuda.set_device(device)
    return device


def init_from_env(backend: str,
                  device: Union[str, torch.device, None] = None,
                  env: Optional[Dict[str, str]] = None) -> Mesh:
    """Start the default process group from torchrun's environment and
    return this rank's :class:`Mesh`.  `backend` is 'nccl' (the device is
    ``cuda:LOCAL_RANK``) or 'gloo' (the CPU, or `device` where the caller
    names one; 'cuda' without an index is ``cuda:LOCAL_RANK``).  Missing
    variables, a missing card or a failing init raise."""
    env = os.environ if env is None else env
    missing = [k for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                           'MASTER_PORT') if k not in env]
    if missing:
        raise RuntimeError(f'the process group needs {missing} in the '
                           f'environment (torchrun sets them)')
    rank, size = int(env['RANK']), int(env['WORLD_SIZE'])
    local_rank = int(env.get('LOCAL_RANK', rank))
    device = _device_for(backend, local_rank, device)
    dist.init_process_group(
        backend, init_method=f'tcp://{env["MASTER_ADDR"]}:'
                             f'{env["MASTER_PORT"]}',
        rank=rank, world_size=size)
    return Mesh(rank, size, device)


def make_mesh_2d(mesh: Mesh, space: int = 1) -> Mesh:
    """JAX's ``('data', 'space')`` mesh over the ranks of `mesh` (the
    default group): `mesh` itself for ``space == 1``; else the same rank
    with its ``data`` and ``space`` meshes (module docstring).  Every rank
    creates every group, in the same order.  The world size must divide
    by `space` (JAX's trainer trims its mesh to a device count that
    divides instead)."""
    if space < 1:
        raise ValueError(f'spatial_split={space}: expected 1 or more')
    if space == 1:
        return mesh
    if mesh.group is not None or mesh.space is not None:
        raise ValueError('make_mesh_2d splits the default group\'s mesh')
    if mesh.size % space:
        raise ValueError(f'spatial_split={space} does not divide the '
                         f'{mesh.size} ranks; the JAX trainer trims its '
                         f'mesh to a device count that divides, the port '
                         f'asks for a world size that divides')
    n_data = mesh.size // space
    d, s = divmod(mesh.rank, space)
    space_group = data_group = None
    for i in range(n_data):
        g = dist.new_group([i * space + j for j in range(space)])
        if i == d:
            space_group = g
    for j in range(space):
        g = dist.new_group([i * space + j for i in range(n_data)])
        if j == s:
            data_group = g
    return dataclasses.replace(
        mesh, data=Mesh(d, n_data, mesh.device, data_group),
        space=Mesh(s, space, mesh.device, space_group))


def shard_batch(batch: Any, rank: int, world: int) -> Any:
    """Rank `rank`'s rows ``[rank * b / world, (rank + 1) * b / world)`` of
    a global batch: a dict of arrays or tensors (each sliced on dim 0, the
    bit-packed masks and the augment draws too; other values kept), or one
    array or tensor."""
    def take(x):
        if not hasattr(x, 'shape') or not x.shape:
            return x
        return x[Mesh(rank, world, torch.device('cpu')).rows(x.shape[0])]
    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    return take(batch)


def destroy() -> None:
    """End the default process group, where one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()
