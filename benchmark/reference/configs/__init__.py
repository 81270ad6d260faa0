"""The reference's configs beyond the two that ``config.py`` builds in,
one module a config: ``<name>.py`` defines ``CONFIG``, a
``benchmark.reference.config.YolactConfig`` whose ``name`` is ``<name>``
(``config.get_config``).  A module here imports nothing of the port or of
JAX."""
