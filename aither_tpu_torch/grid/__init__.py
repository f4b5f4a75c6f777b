"""Host layers (geometry, ghost nodes and connections) copied from ``aither_tpu/grid/`` so that the
port imports nothing of the JAX package.  Only imports (and, in
``grid/connections.py``, the numpy-only orientation helpers) differ
from the originals; keep them diffable."""
