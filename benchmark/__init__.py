"""The benchmark of the PyTorch / CUDA port (``yolact_tpu_torch``).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``workloads/<cell>.json``, ``metrics/<metric>.py``
and ``modes/<mode>.py`` (the loop a mix names).  ``reference/`` is a
frozen plain-PyTorch copy of the port's model, detection and training
math, which decides ``correct``; it imports nothing of the port.  Nothing
here imports JAX or the JAX package.
"""
