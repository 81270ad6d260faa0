"""``yolact_darknet53``: dbolya/yolact ``data/config.py``'s
``yolact_darknet53_config`` (the README's "Darknet53-FPN 550" row):
yolact_base with the DarkNet-53 trunk of ``darknet53_backbone``
(``models/darknet.py``), pixels / 255 in RGB (``darknet_transform``), the
FPN on stages 2-4 (256, 512 and 1,024 channels) and yolact_base's anchors
(pixel scales, square anchors: 19,248 priors at 550)."""

from benchmark.reference.config import (YOLACT_BASE_CONFIG, BackboneConfig,
                                        TransformConfig)

DARKNET_TRANSFORM = TransformConfig(channel_order='RGB', normalize=False,
                                    subtract_means=False, to_float=True)

DARKNET53_BACKBONE = BackboneConfig(
    name='DarkNet53', path='darknet53.pth', type='darknet',
    args=((1, 2, 8, 8, 4),),
    transform=DARKNET_TRANSFORM)

CONFIG = YOLACT_BASE_CONFIG.copy(
    name='yolact_darknet53',
    backbone=DARKNET53_BACKBONE.copy(
        selected_layers=tuple(range(2, 5)),
        pred_scales=YOLACT_BASE_CONFIG.backbone.pred_scales,
        pred_aspect_ratios=YOLACT_BASE_CONFIG.backbone.pred_aspect_ratios,
        use_pixel_scales=True,
        preapply_sqrt=False,
        use_square_anchors=True))
