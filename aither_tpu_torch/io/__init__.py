"""Host layers (deck parser and Plot3D reader) copied from ``aither_tpu/io/`` so that the
port imports nothing of the JAX package.  Only imports (and, in
``grid/connections.py``, the numpy-only orientation helpers) differ
from the originals; keep them diffable."""
