"""Data parallelism of the port (``parallel/mesh.py``)."""
