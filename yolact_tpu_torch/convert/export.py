"""Export of the whole inference program as one ``torch.export`` artifact.

Port of ``yolact_tpu/convert/export.py``.  The device preprocess, backbone,
FPN, protonet, heads, softmax, fast NMS (the candidate branch as a
``torch.cond``, as JAX's ``lax.cond``), mask assembly and, for YOLACT++,
the maskiou re-scoring are traced by ``torch.export`` into one
``ExportedProgram`` with the weights in it, and saved as a ``.pt2`` file.
The hand-written kernels are ``torch.library`` custom ops
(``torch.ops.yolact_tpu_torch.*``, registered by ``yolact_tpu_torch.kernels``)
in the graph, so the artifact launches the same kernels as ``Pipeline``.

Two deltas from the JAX artifact, both deliberate:

* loading needs torch and this package (for its custom ops), where JAX's
  StableHLO artifact needs only jax;
* the artifact runs on the device it was exported on (``meta['device']``);
  JAX lowers for other platforms (``platforms``), which has no counterpart.

Artifact: one ``.pt2`` file (``torch.export.save``) with ``meta.json`` among
its extra files: config name, batch, height, width, version, preprocess,
score_threshold, has_mask_scores, fields (the outputs in
``InferenceOutput`` order, ``None`` fields dropped), device and
compute_dtype.

Usage::

    from yolact_tpu_torch.convert.export import export_inference, load_exported
    export_inference(cfg, state_dict, 'model.pt2', batch_size=1)
    runner = load_exported('model.pt2')
    out = runner(images)          # a tuple in meta['fields'] order
"""

from __future__ import annotations

import json
import zipfile
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

import yolact_tpu_torch.kernels  # noqa: F401  (registers the custom ops)
from yolact_tpu_torch.config import MaskType, YolactConfig
from yolact_tpu_torch.infer import (check_device, forward_and_detect,
                                    load_model, maybe_enable_stem_s2d,
                                    use_float32_math)

EXPORT_VERSION = 1
META_FILE = 'meta.json'


def output_fields(cfg: YolactConfig):
    """The artifact's outputs: ``InferenceOutput``'s fields that are not
    None for `cfg` (``mask_scores`` where the maskiou net re-scores)."""
    fields = ['boxes', 'classes', 'scores', 'masks', 'valid']
    if (cfg.use_maskiou and cfg.eval_mask_branch
            and cfg.mask_type != MaskType.DIRECT):
        fields.append('mask_scores')
    return fields


class InferenceProgram(nn.Module):
    """``forward_and_detect`` as a module: raw [B, H, W, 3] BGR frames ->
    a plain tuple in ``InferenceOutput`` field order (None fields
    dropped), which an exported program returns as it is."""

    def __init__(self, cfg: YolactConfig, model: nn.Module, preprocess: bool,
                 score_threshold: float):
        super().__init__()
        self.cfg = cfg
        self.model = model
        self.preprocess = preprocess
        self.score_threshold = score_threshold

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out = forward_and_detect(self.cfg, self.model, images,
                                 preprocess=self.preprocess,
                                 score_threshold=self.score_threshold)
        return tuple(x for x in out if x is not None)


def export_inference(cfg: YolactConfig, state_dict: Dict[str, torch.Tensor],
                     path: str, batch_size: int = 1,
                     height: Optional[int] = None,
                     width: Optional[int] = None,
                     device: Union[str, torch.device] = 'cuda',
                     preprocess: bool = True, score_threshold: float = 0.0,
                     compute_dtype: Optional[str] = None) -> Dict:
    """Export the inference program for `batch_size` raw BGR frames of
    (height, width), by default the config's square size, on `device`, in
    `compute_dtype` (default ``cfg.compute_dtype``; float32 turns TF32
    off), and save it to `path`.  The model is built as ``Pipeline``
    builds it (the space-to-depth stem for raw frames where the config
    supports it).  Returns the artifact's meta."""
    device = check_device(device)
    if preprocess:
        cfg = maybe_enable_stem_s2d(cfg)
    compute_dtype = compute_dtype or cfg.compute_dtype
    model = load_model(cfg, state_dict, device, compute_dtype)
    model.requires_grad_(False)
    h = height or cfg.max_size
    w = width or cfg.max_size
    program = InferenceProgram(cfg, model, preprocess, score_threshold)
    ep = torch.export.export(
        program, (torch.zeros((batch_size, h, w, 3), dtype=torch.float32,
                              device=device),))
    meta = dict(config=cfg.name, batch=batch_size, height=h, width=w,
                version=EXPORT_VERSION, preprocess=preprocess,
                score_threshold=score_threshold,
                has_mask_scores='mask_scores' in output_fields(cfg),
                fields=output_fields(cfg), device=str(device),
                compute_dtype=compute_dtype)
    torch.export.save(ep, path, extra_files={META_FILE: json.dumps(meta)})
    return meta


class ExportedRunner:
    """A loaded artifact: ``meta`` and a call on a batch of frames."""

    def __init__(self, meta: Dict, program: torch.export.ExportedProgram):
        self.meta = meta
        self.program = program
        self.device = torch.device(meta['device'])
        self._module = program.module()

    def __call__(self, images) -> Tuple[torch.Tensor, ...]:
        """[batch, height, width, 3] BGR frames (numpy or a tensor, on any
        device) -> the outputs in ``meta['fields']`` order, on the
        artifact's device."""
        with torch.inference_mode():
            x = torch.as_tensor(images, dtype=torch.float32,
                                device=self.device)
            return self._module(x)


def read_meta(path: str) -> Dict:
    """An artifact's meta, read from the ``.pt2`` archive without loading
    the program."""
    with zipfile.ZipFile(path) as z:
        name, = (n for n in z.namelist()
                 if n.endswith('/extra/' + META_FILE))
        return json.loads(z.read(name))


def load_exported(path: str) -> ExportedRunner:
    """Load an artifact of :func:`export_inference`.  Its device must be
    present (there is no CPU fallback); a float32 artifact turns TF32 off
    in this process, as a float32 ``Pipeline`` does."""
    meta = read_meta(path)
    check_device(meta['device'])
    program = torch.export.load(path)
    use_float32_math(meta['compute_dtype'])
    return ExportedRunner(meta, program)
