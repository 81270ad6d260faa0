"""SSD-style VGG-16 backbone, over channels_last maps.

Port of ``yolact_tpu/models/vgg.py`` (reference ``backbone.py:324-444``).
The architecture is the reference's nested-tuple mini-language: per group,
``'M'`` is a max pool and an int a conv's channels, either optionally paired
with a kwargs tuple (the ``ceil_mode`` pool of group 3, the 3/1/1 pool and
the ``dilation=6`` fc6 conv of group 5).  Each group is an
``nn.Sequential`` with a ReLU after every conv, so the parameter names are
the reference's ``layers.{g}.{i}`` with ``i`` counting the ReLU slots
(``yolact_tpu/convert/torch_import.py:177-191``).  ``norm_layers`` puts a
batch norm (``norms.{i}``) on those groups' outputs; ``extra_args`` are the
SSD extra stages, a 1x1 squeeze then a 3x3 conv with stride ``ds``.

The wiring is ``forward_rows``, which runs each group on a rank's rows of
its map under a spatial split (``parallel/mesh.py``; the convs and pools
of ``models/layers.py:run_rows`` fetch their halos, -inf for the pools),
or on the whole map (``rows`` None, which ``forward`` passes).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
from torch import nn

from yolact_tpu_torch.models.layers import BatchNorm2d, Conv2d, run_rows
from yolact_tpu_torch.parallel.mesh import Rows


def _parse(v):
    if isinstance(v, tuple):
        return v[0], dict(v[1])
    return v, None


class VGGBackbone(nn.Module):
    """Returns one feature map per group and extra stage.  ``use_kernels``
    and ``remat`` are accepted for the ResNet call signature and change
    nothing."""

    def __init__(self, arch: Sequence[Any],
                 extra_args: Sequence[Tuple[int, int]] = (),
                 norm_layers: Sequence[int] = (),
                 num_stages: Optional[int] = None):
        super().__init__()
        # the extra stages take no batch norm
        self.norm_layers = tuple(g for g in norm_layers if g < len(arch))
        groups, norms = [], {}
        ch = 3
        for gi, group in enumerate(arch):
            mods = []
            for v in group:
                v, kw = _parse(v)
                if v == 'M':
                    kw = kw or {'kernel_size': 2, 'stride': 2}
                    mods.append(nn.MaxPool2d(
                        kw.get('kernel_size', 2), kw.get('stride', 2),
                        kw.get('padding', 0),
                        ceil_mode=kw.get('ceil_mode', False)))
                else:
                    # the 3x3/p1 default holds only for an entry without
                    # kwargs (the reference's `args is None`)
                    kw = kw or {'kernel_size': 3, 'padding': 1}
                    mods += [Conv2d(ch, v, kw.get('kernel_size', 3),
                                    stride=kw.get('stride', 1),
                                    padding=kw.get('padding', 0),
                                    dilation=kw.get('dilation', 1)),
                             nn.ReLU()]
                    ch = v
            if gi in self.norm_layers:
                norms[self.norm_layers.index(gi)] = BatchNorm2d(ch)
            groups.append(nn.Sequential(*mods))
        n_extra = max(0, (num_stages or len(arch)) - len(arch))
        extras = list(extra_args) + [(128, 2)] * n_extra
        for ei in range(n_extra):
            out, ds = extras[ei]
            groups.append(nn.Sequential(
                Conv2d(ch, out, 1), nn.ReLU(),
                Conv2d(out, out * 2, 3, stride=ds, padding=1 if ds > 1 else 0),
                nn.ReLU()))
            ch = out * 2
        self.layers = nn.ModuleList(groups)
        self.norms = nn.ModuleList(norms[i] for i in range(len(norms)))

    def forward(self, x: torch.Tensor, use_kernels: bool = True,
                bn_train: bool = False,
                remat: str = 'none') -> Tuple[torch.Tensor, ...]:
        return self.forward_rows(x, None, use_kernels, bn_train, remat)[0]

    def forward_rows(self, x: torch.Tensor, rows: Optional[Rows],
                     use_kernels: bool = True, bn_train: bool = False,
                     remat: str = 'none'
                     ) -> Tuple[Tuple[torch.Tensor, ...],
                                Tuple[Optional[Rows], ...]]:
        """:meth:`forward` on a rank's rows of the input (`rows`; None:
        the whole input), with each output's rows."""
        outs, heights = [], []
        for gi, group in enumerate(self.layers):
            x, rows = run_rows(group, x, rows)
            if gi in self.norm_layers:
                x = self.norms[self.norm_layers.index(gi)](x, bn_train, rows)
            outs.append(x)
            heights.append(rows)
        return tuple(outs), tuple(heights)
