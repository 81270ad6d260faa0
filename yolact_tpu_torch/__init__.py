"""PyTorch + CUDA port of YOLACT for NVIDIA Hopper, beside the JAX package.

The JAX package (``yolact_tpu``) is the reference this port is held
against.  Module layout mirrors it one to one; inside, the port uses
PyTorch's idiom (NCHW ``nn.Module``s, explicit devices and generators).
At the public functions it keeps the JAX layouts: images in as
``[B, H, W, 3]`` BGR float, prototypes ``[B, Hp, Wp, Md]``, masks out as
``[B, D, Hp, Wp]`` and relative point-form boxes ``[B, D, 4]``.

The port imports nothing of the JAX package.  Where it needs a module of
it that is free of JAX (the configuration, the COCO dataset, the evaluator,
the host NMS and RLE codec), it keeps its own copy at the same relative
path: ``yolact_tpu_torch/config.py`` is ``yolact_tpu/config.py``, and so
on.  ``convert/from_jax.py:config_from_jax`` turns a JAX config object into
the port's.
"""

from yolact_tpu_torch.config import (  # noqa: F401
    MEANS, STD, MaskType, YolactConfig, get_config)
