"""Immutable configuration: the port's ``config.py`` for the benchmark's
configurations (dbolya/yolact ``data/config.py``), with the dataclasses and
derived sizes they need.

The reference (dbolya/yolact ``data/config.py``) uses a mutable attribute-bag
``Config`` plus a process-global ``cfg`` that the model constructor writes back
into (``yolact.py:407-428``).  Here every config is a frozen dataclass threaded
explicitly through the model, and the values that the reference computes
at runtime (``mask_dim``, ``num_heads``) are derived statically, so that a
config fully determines the model.

Both are found by name, so that a configuration joins as new files alone:
:func:`get_config` resolves ``yolact_base`` and ``yolact_plus_base`` here
and any other name as the module ``reference/configs/<name>.py``, whose
``CONFIG`` is that config; :func:`backbone_family` resolves a backbone
``type`` as the module ``reference/models/<type>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Constants (values mirror dbolya/yolact data/config.py:28-56)
# ---------------------------------------------------------------------------

# BGR ImageNet statistics, used by the `normalize` transform mode.
MEANS = (103.94, 116.78, 123.68)
STD = (57.38, 57.12, 58.40)

COCO_CLASSES = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus',
    'train', 'truck', 'boat', 'traffic light', 'fire hydrant',
    'stop sign', 'parking meter', 'bench', 'bird', 'cat', 'dog',
    'horse', 'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe',
    'backpack', 'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee',
    'skis', 'snowboard', 'sports ball', 'kite', 'baseball bat',
    'baseball glove', 'skateboard', 'surfboard', 'tennis racket',
    'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon', 'bowl',
    'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
    'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch',
    'potted plant', 'bed', 'dining table', 'toilet', 'tv', 'laptop',
    'mouse', 'remote', 'keyboard', 'cell phone', 'microwave', 'oven',
    'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
    'scissors', 'teddy bear', 'hair drier', 'toothbrush')

# COCO category ids are not contiguous; map category_id -> 1-indexed class.
COCO_LABEL_MAP = {
    1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 7, 8: 8,
    9: 9, 10: 10, 11: 11, 13: 12, 14: 13, 15: 14, 16: 15, 17: 16,
    18: 17, 19: 18, 20: 19, 21: 20, 22: 21, 23: 22, 24: 23, 25: 24,
    27: 25, 28: 26, 31: 27, 32: 28, 33: 29, 34: 30, 35: 31, 36: 32,
    37: 33, 38: 34, 39: 35, 40: 36, 41: 37, 42: 38, 43: 39, 44: 40,
    46: 41, 47: 42, 48: 43, 49: 44, 50: 45, 51: 46, 52: 47, 53: 48,
    54: 49, 55: 50, 56: 51, 57: 52, 58: 53, 59: 54, 60: 55, 61: 56,
    62: 57, 63: 58, 64: 59, 65: 60, 67: 61, 70: 62, 72: 63, 73: 64,
    74: 65, 75: 66, 76: 67, 77: 68, 78: 69, 79: 70, 80: 71, 81: 72,
    82: 73, 84: 74, 85: 75, 86: 76, 87: 77, 88: 78, 89: 79, 90: 80}

class MaskType:
    """Mask branch types (reference ``data/config.py:307-365``)."""
    DIRECT = 0
    LINCOMB = 1


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

def _freeze(x):
    """Recursively convert lists/dicts to tuples for hashability."""
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    return x


@dataclass(frozen=True)
class DatasetConfig:
    name: str = 'Base Dataset'
    train_images: str = './data/coco/images/'
    train_info: str = 'path_to_annotation_file'
    valid_images: str = './data/coco/images/'
    valid_info: str = 'path_to_annotation_file'
    has_gt: bool = True
    class_names: Tuple[str, ...] = COCO_CLASSES
    # None => category ids start at 1 and are sequential.
    label_map: Optional[Tuple[Tuple[int, int], ...]] = None

    def copy(self, **kw) -> 'DatasetConfig':
        return dataclasses.replace(self, **kw)

    @property
    def label_map_dict(self) -> Optional[Dict[int, int]]:
        return dict(self.label_map) if self.label_map is not None else None


_COCO_LABEL_MAP_T = tuple(sorted(COCO_LABEL_MAP.items()))

COCO2014_DATASET = DatasetConfig(
    name='COCO 2014',
    train_info='./data/coco/annotations/instances_train2014.json',
    valid_info='./data/coco/annotations/instances_val2014.json',
    label_map=_COCO_LABEL_MAP_T)

COCO2017_DATASET = DatasetConfig(
    name='COCO 2017',
    train_info='./data/coco/annotations/instances_train2017.json',
    valid_info='./data/coco/annotations/instances_val2017.json',
    label_map=_COCO_LABEL_MAP_T)

@dataclass(frozen=True)
class TransformConfig:
    """Input normalisation mode per backbone (``data/config.py:181-202``)."""
    channel_order: str = 'RGB'
    normalize: bool = True
    subtract_means: bool = False
    to_float: bool = False


RESNET_TRANSFORM = TransformConfig(normalize=True)


@dataclass(frozen=True)
class BackboneConfig:
    """Backbone family + anchor layout (``data/config.py:210-299``).

    ``type`` names the backbone family instead of a live class
    reference: the module ``models/<type>.py`` (:func:`backbone_family`).
    """
    name: str = 'Base Backbone'
    path: str = 'path/to/pretrained/weights'
    type: str = 'resnet'
    args: Tuple[Any, ...] = ()
    transform: TransformConfig = RESNET_TRANSFORM
    selected_layers: Tuple[int, ...] = ()
    pred_scales: Tuple[Tuple[float, ...], ...] = ()
    pred_aspect_ratios: Tuple[Any, ...] = ()
    use_pixel_scales: bool = False
    preapply_sqrt: bool = True
    use_square_anchors: bool = False

    def copy(self, **kw) -> 'BackboneConfig':
        for k in ('args', 'selected_layers', 'pred_scales', 'pred_aspect_ratios'):
            if k in kw:
                kw[k] = _freeze(kw[k])
        return dataclasses.replace(self, **kw)


_RETINA_ARS = ((0.66685089, 1.7073535, 0.87508774, 1.16524493, 0.49059086),)

RESNET101_BACKBONE = BackboneConfig(
    name='ResNet101', path='resnet101_reducedfc.pth', type='resnet',
    args=((3, 4, 23, 3),),
    selected_layers=tuple(range(2, 8)),
    pred_scales=((1,),) * 6,
    pred_aspect_ratios=(_RETINA_ARS,) * 6)

RESNET101_DCN_INTER3_BACKBONE = RESNET101_BACKBONE.copy(
    name='ResNet101_DCN_Interval3',
    args=((3, 4, 23, 3), (0, 4, 23, 3), 3))

@dataclass(frozen=True)
class FPNConfig:
    """FPN hyperparameters (``data/config.py:387-409``)."""
    num_features: int = 256
    interpolation_mode: str = 'bilinear'
    num_downsample: int = 1
    use_conv_downsample: bool = False
    pad: bool = True
    relu_downsample_layers: bool = False
    relu_pred_layers: bool = True

    def copy(self, **kw) -> 'FPNConfig':
        return dataclasses.replace(self, **kw)


FPN_BASE = FPNConfig()


# ---------------------------------------------------------------------------
# Master config
# ---------------------------------------------------------------------------

# Layer spec entry used by mask_proto_net / extra_head_net / maskiou_net:
#   (channels, kernel_size, kwargs-tuple)
#   channels=None & k<0  -> bilinear upsample by |k|
#   channels=int  & k<0  -> transposed conv
#   channels=int  & k>0  -> conv
LayerSpec = Tuple[Any, ...]


@dataclass(frozen=True)
class YolactConfig:
    """Full model + training configuration.

    Field-for-field parity with ``coco_base_config``
    (``dbolya/yolact data/config.py:417-648``); activation/config-object
    fields hold string keys / nested frozen dataclasses instead of live
    callables so the whole config hashes and can key a jit cache.
    """
    name: str = 'base_config'
    dataset: DatasetConfig = COCO2014_DATASET
    num_classes: int = 81  # includes background

    max_iter: int = 400000
    max_num_detections: int = 100

    lr: float = 1e-3
    momentum: float = 0.9
    decay: float = 5e-4
    gamma: float = 0.1
    lr_steps: Tuple[int, ...] = (280000, 360000, 400000)
    lr_warmup_init: float = 1e-4
    lr_warmup_until: int = 500

    conf_alpha: float = 1
    bbox_alpha: float = 1.5
    mask_alpha: float = 0.4 / 256 * 140 * 140

    eval_mask_branch: bool = True

    nms_top_k: int = 200
    nms_conf_thresh: float = 0.05
    nms_thresh: float = 0.5

    mask_type: int = MaskType.DIRECT
    mask_size: int = 16
    masks_to_train: int = 100
    mask_proto_src: Optional[int] = None
    mask_proto_net: Tuple[LayerSpec, ...] = ((256, 3, ()), (256, 3, ()))
    mask_proto_bias: bool = False
    mask_proto_prototype_activation: str = 'relu'
    mask_proto_mask_activation: str = 'sigmoid'
    mask_proto_coeff_activation: str = 'tanh'
    mask_proto_crop: bool = True
    mask_proto_crop_expand: float = 0    # declared-but-never-read in the reference too
    mask_proto_loss: Optional[str] = None
    mask_proto_binarize_downsampled_gt: bool = True
    mask_proto_normalize_mask_loss_by_sqrt_area: bool = False
    mask_proto_reweight_mask_loss: bool = False
    mask_proto_grid_file: str = 'data/grid.npy'
    mask_proto_use_grid: bool = False
    mask_proto_coeff_gate: bool = False
    mask_proto_prototypes_as_features: bool = False
    mask_proto_prototypes_as_features_no_grad: bool = False
    mask_proto_remove_empty_masks: bool = False
    mask_proto_reweight_coeff: float = 1
    mask_proto_coeff_diversity_loss: bool = False
    mask_proto_coeff_diversity_alpha: float = 1
    mask_proto_normalize_emulate_roi_pooling: bool = False
    mask_proto_double_loss: bool = False
    mask_proto_double_loss_alpha: float = 1
    mask_proto_split_prototypes_by_head: bool = False
    mask_proto_crop_with_pred_box: bool = False

    augment_photometric_distort: bool = True
    augment_expand: bool = True
    augment_random_sample_crop: bool = True
    augment_random_mirror: bool = True
    augment_random_flip: bool = False
    augment_random_rot90: bool = False

    discard_box_width: float = 4 / 550
    discard_box_height: float = 4 / 550

    freeze_bn: bool = False
    fpn: Optional[FPNConfig] = None
    share_prediction_module: bool = False
    ohem_use_most_confident: bool = False

    use_focal_loss: bool = False
    focal_loss_alpha: float = 0.25
    focal_loss_gamma: float = 2
    focal_loss_init_pi: float = 0.01
    use_class_balanced_conf: bool = False
    use_sigmoid_focal_loss: bool = False
    use_objectness_score: bool = False

    use_class_existence_loss: bool = False
    class_existence_alpha: float = 1
    use_semantic_segmentation_loss: bool = False
    semantic_segmentation_alpha: float = 1

    use_mask_scoring: bool = False
    mask_scoring_alpha: float = 1        # declared-but-never-read in the reference too
    use_change_matching: bool = False

    extra_head_net: Optional[Tuple[LayerSpec, ...]] = None
    head_layer_params: Tuple[Tuple[str, Any], ...] = (('kernel_size', 3), ('padding', 1))
    extra_layers: Tuple[int, int, int] = (0, 0, 0)

    positive_iou_threshold: float = 0.5
    negative_iou_threshold: float = 0.5
    ohem_negpos_ratio: int = 3
    crowd_iou_threshold: float = 1

    max_size: int = 300
    force_cpu_nms: bool = True           # declared-but-never-read in the reference too
    use_coeff_nms: bool = False          # declared-but-never-read in the reference too
    use_instance_coeff: bool = False
    num_instance_coeffs: int = 64

    train_masks: bool = True
    train_boxes: bool = True
    use_gt_bboxes: bool = False
    preserve_aspect_ratio: bool = False
    use_prediction_module: bool = False
    use_yolo_regressors: bool = False
    use_prediction_matching: bool = False

    delayed_settings: Tuple[Tuple[int, Tuple[Tuple[str, Any], ...]], ...] = ()
    no_jit: bool = False                 # torch-jit toggle; meaningless under XLA

    backbone: Optional[BackboneConfig] = None

    use_maskiou: bool = False
    maskiou_net: Tuple[LayerSpec, ...] = ()
    discard_mask_area: float = -1
    maskiou_alpha: float = 1.0
    rescore_mask: bool = False
    rescore_bbox: bool = False
    maskious_to_train: int = -1

    # ------------------------------------------------------------------
    # TPU-specific knobs (no reference equivalent)
    # ------------------------------------------------------------------
    # Compute dtype for the conv trunk; params always stay float32.
    compute_dtype: str = 'float32'
    # Detection candidate pruning: keep the top-N priors by best class
    # score before the per-class NMS sorts (0 = disables the fast path).
    # EXACT reference semantics either way: detect() counts the priors
    # passing nms_conf_thresh at runtime and lax.cond-falls back to the
    # unpruned tail for any batch where more than N pass, so the pruned
    # path only ever runs when it is provably lossless
    # (detect/detection.py; crowded-image oracle in test_detect_oracle.py).
    nms_candidates: int = 1024
    # Run SSD augmentation on device inside the jitted train step
    # (data/device_augment.py) — needed when the host cannot feed the chip.
    use_device_augment: bool = False
    # Space-to-depth stem (inference): the pipeline feeds the ResNet a
    # normalized 2x2-space-to-depth [B,S/2,S/2,12] tensor in RAW (BGR)
    # channel order and conv1 runs as an equivalent 4x4/s1 conv with the
    # BGR->RGB flip folded into its kernel.  Avoids the C=3 lane-padding
    # tax on every full-image op (profiled ~20% of b8 inference).  Same
    # checkpoint params; enabled automatically by infer.Pipeline for
    # ResNet backbones (see infer.maybe_enable_stem_s2d).
    stem_s2d: bool = False
    # Rematerialize backbone bottleneck blocks in the training backward
    # pass ('none' | 'dcn' | 'all'):  'dcn' wraps only DCN blocks in
    # jax.checkpoint, discarding their big gather/im2col intermediates
    # between fwd and bwd.  Without it the yolact_plus train step peaks
    # at ~14.4 GiB temp HBM at b8 550² f32 (probe_dcn_bwd memanal) on a
    # 16 GiB chip.  No effect on inference or on the param tree.
    # Unknown values raise at model trace time.
    train_remat: str = 'dcn'

    def copy(self, **kw) -> 'YolactConfig':
        for k in ('mask_proto_net', 'extra_head_net', 'maskiou_net',
                  'lr_steps', 'extra_layers', 'head_layer_params',
                  'delayed_settings'):
            if k in kw and kw[k] is not None:
                kw[k] = _freeze(kw[k])
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Derived values (reference computes these by mutating cfg at runtime:
    # yolact.py:407-428 for mask_dim, yolact.py:445 for num_heads).
    # ------------------------------------------------------------------
    @property
    def mask_dim(self) -> int:
        if self.mask_type == MaskType.DIRECT:
            return self.mask_size ** 2
        dim = net_spec_out_channels(self.mask_proto_net, self.proto_in_channels)
        if self.mask_proto_bias:
            dim += 1
        return dim

    @property
    def proto_in_channels(self) -> int:
        if self.mask_proto_src is None:
            return 3
        if self.fpn is not None:
            return self.fpn.num_features
        # without an FPN the model feeds the protonet the mask_proto_src-th
        # SELECTED backbone output (models/yolact.py), not the raw stage
        sel = self.backbone.selected_layers[self.mask_proto_src]
        return backbone_channels(self.backbone)[sel]

    @property
    def num_heads(self) -> int:
        n = len(self.backbone.selected_layers)
        if self.fpn is not None:
            n += self.fpn.num_downsample
        return n

    @property
    def head_layer_params_dict(self) -> Dict[str, Any]:
        return dict(self.head_layer_params)


def net_spec_out_channels(spec: Tuple[LayerSpec, ...], in_channels: int) -> int:
    """Output channel count of a make_net-style layer spec.

    Mirrors the channel bookkeeping of the reference's ``make_net``
    (``utils/functions.py:163-213``) without building anything.
    """
    ch = in_channels
    for entry in spec:
        num = entry[0]
        if isinstance(num, str):
            if num == 'cat':
                ch = sum(net_spec_out_channels(sub, ch) for sub in entry[1])
            continue
        if num is not None:
            ch = num
    return ch


def _import_if_there(name: str):
    """The module `name`, or None where there is no such module (an error
    inside a module that is there propagates)."""
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None


class UnknownBackbone(ValueError, NotImplementedError):
    """A backbone ``type`` with no family module.  Both base classes, so
    that it is what each of the family's callers raised before it was
    looked up by name."""


FAMILY_FUNCTIONS = ('build_backbone', 'out_channels', 'feature_sizes_1d')


def backbone_family(bb_type: str):
    """The module ``benchmark.reference.models.<bb_type>`` of a backbone
    family, imported on first use (the models import this module).  It
    defines:

    * ``build_backbone(cfg)``: the trunk, an ``nn.Module`` whose
      ``forward(x, use_kernels, bn_train=..., remat=...)`` returns one
      feature map a stage;
    * ``out_channels(bb)``: each stage's output channels;
    * ``feature_sizes_1d(cfg, img)``: each stage's output size along one
      side of an `img`-pixel input.
    """
    name = f'benchmark.reference.models.{bb_type}'
    module = _import_if_there(name) if bb_type.isidentifier() else None
    missing = [f for f in FAMILY_FUNCTIONS if not hasattr(module, f)]
    if missing:
        raise UnknownBackbone(f'unknown backbone type {bb_type!r}: no '
                              f'module {name} with {", ".join(missing)}')
    return module


def backbone_channels(bb: BackboneConfig) -> Tuple[int, ...]:
    """Per-stage output channels of the backbone, from its family."""
    return tuple(backbone_family(bb.type).out_channels(bb))


# ---------------------------------------------------------------------------
# Named configs (parity with data/config.py:656-807)
# ---------------------------------------------------------------------------

COCO_BASE_CONFIG = YolactConfig()

YOLACT_BASE_CONFIG = COCO_BASE_CONFIG.copy(
    name='yolact_base',
    dataset=COCO2017_DATASET,
    num_classes=len(COCO2017_DATASET.class_names) + 1,
    max_size=550,
    lr_steps=(280000, 600000, 700000, 750000),
    max_iter=800000,
    backbone=RESNET101_BACKBONE.copy(
        selected_layers=tuple(range(1, 4)),
        use_pixel_scales=True,
        preapply_sqrt=False,
        use_square_anchors=True,  # bug-compat with reference anchors
        pred_aspect_ratios=(((1, 0.5, 2),),) * 5,
        pred_scales=((24,), (48,), (96,), (192,), (384,))),
    fpn=FPN_BASE.copy(use_conv_downsample=True, num_downsample=2),
    mask_type=MaskType.LINCOMB,
    mask_alpha=6.125,
    mask_proto_src=0,
    mask_proto_net=((256, 3, (('padding', 1),)),) * 3
                   + ((None, -2, ()), (256, 3, (('padding', 1),)))
                   + ((32, 1, ()),),
    mask_proto_normalize_emulate_roi_pooling=True,
    share_prediction_module=True,
    extra_head_net=((256, 3, (('padding', 1),)),),
    positive_iou_threshold=0.5,
    negative_iou_threshold=0.4,
    crowd_iou_threshold=0.7,
    use_semantic_segmentation_loss=True)

_PLUS_SCALES = tuple(tuple(i * 2 ** (j / 3.0) for j in range(3))
                     for i in (24, 48, 96, 192, 384))

YOLACT_PLUS_BASE_CONFIG = YOLACT_BASE_CONFIG.copy(
    name='yolact_plus_base',
    backbone=RESNET101_DCN_INTER3_BACKBONE.copy(
        selected_layers=tuple(range(1, 4)),
        pred_aspect_ratios=(((1, 0.5, 2),),) * 5,
        pred_scales=_PLUS_SCALES,
        use_pixel_scales=True,
        preapply_sqrt=False,
        use_square_anchors=False),
    use_maskiou=True,
    maskiou_net=((8, 3, (('stride', 2),)), (16, 3, (('stride', 2),)),
                 (32, 3, (('stride', 2),)), (64, 3, (('stride', 2),)),
                 (128, 3, (('stride', 2),))),
    maskiou_alpha=25,
    rescore_bbox=False,
    rescore_mask=True,
    discard_mask_area=5 * 5)

_CONFIG_REGISTRY: Dict[str, YolactConfig] = {
    c.name: c for c in (YOLACT_BASE_CONFIG, YOLACT_PLUS_BASE_CONFIG)}


def get_config(name: str) -> YolactConfig:
    """Resolve a config name: accepts 'yolact_base' or 'yolact_base_config'
    (parity with set_cfg, ``data/config.py:812-822``).  A name that is not
    built in is the module ``benchmark.reference.configs.<name>``, whose
    ``CONFIG`` is a :class:`YolactConfig` of that name."""
    key = name[:-len('_config')] if name.endswith('_config') else name
    if key in _CONFIG_REGISTRY:
        return _CONFIG_REGISTRY[key]
    module_name = f'benchmark.reference.configs.{key}'
    module = _import_if_there(module_name) if key.isidentifier() else None
    if module is None:
        from benchmark.reference import configs
        found = sorted(m.name for m in pkgutil.iter_modules(configs.__path__))
        raise KeyError(
            f'Unknown config {name!r}. Built in: {sorted(_CONFIG_REGISTRY)}; '
            f'modules in reference/configs: {found}')
    cfg = module.CONFIG
    if not isinstance(cfg, YolactConfig) or cfg.name != key:
        raise ValueError(f'{module_name}.CONFIG must be a YolactConfig '
                         f'named {key!r}')
    return cfg
