"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch paths, which decides ``correct``.

Copied from ``yolact_tpu_torch`` with its imports rewritten to this
package, so that no later change to the port changes the reference:
``config.py``, ``infer.py``, ``models/``, ``ops/``, ``detect/`` and, for
training, ``train/loss.py``, ``train/matcher.py``, ``train/schedule.py``,
``data/device_augment.py``.  What differs from the port:

* only what the benchmark's configurations run is kept: ``yolact_base``
  and ``yolact_plus_base`` in ``config.py``, any other config as a
  module of ``configs/``, each backbone family as ``models/<type>.py``
  (``config.get_config``, ``config.backbone_family``; the ResNet is the
  one family so far), with an FPN, on one device; no spatial split or
  data-parallel branch;

* ``kernels/`` holds each hand-written kernel's plain version alone,
  under the kernel's name;
* ``detect/detection.py`` has no ``torch.export`` branch and no counter;
* every product's operands pass ``precision.operands`` (the control's
  fp8 rounding; unchanged otherwise);
* ``train/step.py`` is the port's ``train_step`` on one device, written
  out without its mesh branches, and ``data/batch.py`` the loader's
  ``RawResize`` and ``pad_batch`` with its uint8 rounding.

It imports nothing of ``yolact_tpu_torch``, ``yolact_tpu`` or JAX
(``benchmark/tests/test_bench_imports.py``), and runs in float32 with
TF32 off.
"""
