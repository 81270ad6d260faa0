"""PyTorch + CUDA port of YOLACT for NVIDIA Hopper, beside the JAX package.

The JAX package (``yolact_tpu``) is the reference this port is held
against.  Module layout mirrors it one to one; inside, the port uses
PyTorch's idiom (NCHW ``nn.Module``s, explicit devices and generators).
At the public functions it keeps the JAX layouts: images in as
``[B, H, W, 3]`` BGR float, prototypes ``[B, Hp, Wp, Md]``, masks out as
``[B, D, Hp, Wp]`` and relative point-form boxes ``[B, D, 4]``.

The configuration system is shared with the JAX package: ``yolact_tpu.config``
imports only the standard library, so it is re-exported here rather than
copied.  Nothing else under ``yolact_tpu`` is imported at run time.
"""

from yolact_tpu.config import (  # noqa: F401
    MEANS, STD, MaskType, YolactConfig, get_config)
