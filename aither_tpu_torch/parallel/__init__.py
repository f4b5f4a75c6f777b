"""Host layers (cubic decomposition) copied from ``aither_tpu/parallel/`` so that the
port imports nothing of the JAX package.  Only imports (and, in
``grid/connections.py``, the numpy-only orientation helpers) differ
from the originals; keep them diffable."""
