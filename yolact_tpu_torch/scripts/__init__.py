"""The port's counterparts of the JAX package's measurement scripts
(``scripts/train_horizon.py``, ``scripts/map_ab.py``, ``scripts/flops.py``),
run as ``python -m yolact_tpu_torch.scripts.<name>``."""
