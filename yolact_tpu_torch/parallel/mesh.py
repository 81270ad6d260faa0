"""Data parallelism over ``torch.distributed``.  Port of
``yolact_tpu/parallel/mesh.py``.

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

Spatial partitioning (JAX's ``make_mesh_2d`` / ``shard_batch_spatial``,
the image height split over a second mesh axis) is not ported: XLA's SPMD
partitioner inserts the convolutions' halo exchanges there, and PyTorch
has nothing that does; :func:`make_mesh_2d` raises with that reason for a
split above 1.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist

BACKENDS = ('nccl', 'gloo')


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group: its ``rank`` of
    ``size`` and the ``device`` its rows and replica live on."""
    rank: int
    size: int
    device: torch.device

    def rows(self, n: int) -> slice:
        """This rank's rows of a global dimension of `n`."""
        if n % self.size:
            raise ValueError(f'{n} rows do not divide over {self.size} ranks')
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    # ---- collectives (on the default process group) --------------------

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of `t` (no gradient), a new tensor."""
        out = t.detach().clone()
        if self.size > 1:
            dist.all_reduce(out)
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
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        return both[0].masked_fill(both[1] > 0, float('nan'))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` concatenated along dim 0 in rank order (no
        gradient; bool tensors travel as uint8)."""
        if self.size == 1:
            return t.detach().clone()
        src = t.detach().to(torch.uint8) if t.dtype == torch.bool \
            else t.detach()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src.contiguous())
        return torch.cat(parts).to(t.dtype)

    def all_sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of `t`, differentiable: the gradient of each
        rank's input is the sum over ranks of the output's gradients."""
        if self.size == 1:
            return t
        return _AllSum.apply(t)

    def all_sum_grads(self, params: Sequence[torch.nn.Parameter]) -> None:
        """Replace each parameter's ``.grad`` by its sum over ranks, in one
        collective over a flat buffer.  Every rank runs the same graph, so
        the same parameters have a gradient on every rank."""
        if self.size == 1:
            return
        params = [p for p in params if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def all_true(self, flag: bool) -> bool:
        """Whether `flag` holds on every rank."""
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([0.0 if flag else 1.0], device=self.device)
        dist.all_reduce(t)
        return float(t) == 0.0

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


class _AllSum(torch.autograd.Function):
    """The sum over ranks, whose gradient is the sum over ranks of the
    output's gradients (every rank's output depends on every input)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


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
    """JAX's ('data', 'space') mesh: `mesh` for ``space == 1``; a split of
    the image height over devices raises (see the module docstring)."""
    if space > 1:
        raise NotImplementedError(
            f'spatial_split={space}: splitting the image height over devices '
            f'needs the convolutions\' halo exchanges, which XLA\'s SPMD '
            f'partitioner inserts in the JAX package and PyTorch does not; '
            f'the port splits the batch only')
    return mesh


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
