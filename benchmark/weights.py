"""Seeded random weights, made on the card in a few large draws.

The init scheme is the JAX package's, as ``yolact_tpu_torch/infer.py:
random_state_dict`` writes it (xavier-uniform convolutions, zero biases,
identity batch norm, a DCN offset conv at zero and its weight a truncated
normal of variance 2/fan_in, flax's Dense default for the class-existence
layer), drawn here from one ``torch.Generator`` on the card: one uniform
draw for every xavier leaf, one for every truncated-normal leaf, each leaf
a slice of it.  The cell's configuration file then shapes them
(:func:`shape`): the conf head scaled and background-biased as a trained
model's (a few hundred candidates an image), the mask coefficients biased
positive, the DCN offset convs seeded non-zero, the residual branches
tamed for training.  The same state dict goes to the program and to the
reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

# flax's truncated normal at +-2 std, rescaled to unit variance
TRUNC = .87962566103423978


def _fans(w: torch.Tensor) -> Tuple[int, int]:
    return nn.init._calculate_fan_in_and_fan_out(w)


def _uniform_slices(gen: torch.Generator, leaves: List[torch.Tensor],
                    dev: torch.device) -> List[torch.Tensor]:
    total = sum(w.numel() for w in leaves)
    flat = torch.rand(total, generator=gen, device=dev)
    out, at = [], 0
    for w in leaves:
        out.append(flat[at:at + w.numel()].view(w.shape))
        at += w.numel()
    return out


def init_state_dict(model: nn.Module, gen: torch.Generator,
                    dcn_type: type, dev: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """The JAX init scheme for `model` (a Yolact of the reference, whose
    parameter names are the port's), float32 on `dev`."""
    sd = {k: v.detach().to(dev, torch.float32)
          for k, v in model.state_dict().items()}
    xavier, trunc = [], []          # (key, std-or-bound source)
    for name, m in model.named_modules():
        pre = name + '.' if name else ''
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            xavier.append(pre + 'weight')
            if m.bias is not None:
                sd[pre + 'bias'].zero_()
        elif isinstance(m, nn.Linear):
            fan_in, _ = _fans(m.weight)
            trunc.append((pre + 'weight', math.sqrt(1.0 / fan_in) / TRUNC))
            sd[pre + 'bias'].zero_()
        elif isinstance(m, dcn_type):
            fan_in = m.weight[0].numel()
            trunc.append((pre + 'weight', math.sqrt(2.0 / fan_in) / TRUNC))
            sd[pre + 'bias'].zero_()
    dcn_offsets = {k for k in xavier if 'conv_offset_mask' in k}
    xavier = [k for k in xavier if k not in dcn_offsets]
    for k in dcn_offsets:
        sd[k].zero_()
    for k, u in zip(xavier, _uniform_slices(gen, [sd[k] for k in xavier],
                                            dev)):
        fan_in, fan_out = _fans(sd[k])
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        sd[k] = (u * 2 - 1) * bound
    lo, hi = (0.5 * (1 + math.erf(a / math.sqrt(2))) for a in (-2.0, 2.0))
    for (k, std), u in zip(trunc, _uniform_slices(
            gen, [sd[k] for k, _ in trunc], dev)):
        sd[k] = torch.erfinv((lo + u * (hi - lo)) * 2 - 1) * (
            math.sqrt(2.0) * std)
    # the pending batch-norm statistics and other buffers keep the
    # module's own values (identity batch norm)
    return sd


def shape(sd: Dict[str, torch.Tensor], shaping: Dict[str, float],
          num_classes: int, gen: torch.Generator
          ) -> Dict[str, torch.Tensor]:
    """The configuration file's ``weights`` shaping, in this order:

    * ``conf_scale``: every conf head scaled (xavier weights leave the
      81-way softmax flat: no prior would pass conf_thresh); the
      background bias is read from the seed's own logits
      (:func:`background_bias`, :func:`add_background_bias`);
    * ``mask_bias``: added to every lincomb coefficient's bias, so that
      an assembled mask is above 0.5 over much of its box;
    * ``dcn_offset_w``, ``dcn_offset_b``: the DCN offset convs seeded
      normal at these scales (the zero init would put every sample on the
      grid);
    * ``residual_scale``: every bottleneck's last batch norm scaled, so
      that the random network's gradients are of order 1, as from a
      pretrained backbone (training).
    """
    sd = dict(sd)
    scale = shaping.get('conf_scale')
    if scale is not None:
        for w in [k for k in sd if k.endswith('.conf_layer.weight')]:
            b = w[:-len('weight')] + 'bias'
            sd[w] = sd[w] * scale
            sd[b] = sd[b] * scale
    if shaping.get('mask_bias'):
        for k in [k for k in sd if k.endswith('.mask_layer.bias')]:
            sd[k] = sd[k] + shaping['mask_bias']
    if shaping.get('dcn_offset_w') is not None:
        keys = sorted(k for k in sd if 'conv_offset_mask' in k)
        flat = torch.randn(sum(sd[k].numel() for k in keys), generator=gen,
                           device=gen.device)
        at = 0
        for k in keys:
            n = sd[k].numel()
            s = shaping['dcn_offset_w' if k.endswith('weight')
                        else 'dcn_offset_b']
            sd[k] = flat[at:at + n].view(sd[k].shape) * s
            at += n
    if shaping.get('residual_scale') is not None:
        for k in [k for k in sd if k.endswith('bn3.weight')]:
            sd[k] = sd[k] * shaping['residual_scale']
    return sd


def background_bias(conf: torch.Tensor, thresh: float, per_image: int,
                    most: int) -> float:
    """The background-logit bias under which `per_image` priors an image
    pass ``conf_thresh`` on average, and no image more than `most`.
    `conf` [B, P, C] are the conf logits without it.  A prior passes where
    its best foreground softmax score exceeds `thresh`: with background
    logit z0 + beta, foreground sum S and best foreground logit m, where
    beta < log(exp(m) / thresh - S) - z0, so each prior has its own
    largest passing bias, and the bias is an order statistic of those."""
    z = conf.float()
    z = z - z.amax(-1, keepdim=True)            # the same scores, no overflow
    fg = z[..., 1:]
    room = fg.amax(-1).exp() / thresh - fg.exp().sum(-1)
    limit = torch.where(room > 0, room.clamp_min(1e-30).log() - z[..., 0],
                        torch.full_like(room, -float('inf')))   # [B, P]
    b = limit.shape[0]
    flat = limit.flatten().sort(descending=True).values
    beta = float(flat[min(per_image * b, flat.numel() - 1)])
    per = limit.sort(dim=1, descending=True).values
    cap = float(per[:, min(most, per.shape[1] - 1)].max())
    return max(beta, cap)


def add_background_bias(sd: Dict[str, torch.Tensor], beta: float,
                        num_classes: int) -> Dict[str, torch.Tensor]:
    sd = dict(sd)
    for b in [k for k in sd if k.endswith('.conf_layer.bias')]:
        bias = sd[b].view(-1, num_classes).clone()
        bias[:, 0] += beta
        sd[b] = bias.view(-1)
    return sd
