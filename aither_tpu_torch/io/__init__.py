"""Host layers copied from ``aither_tpu/io/`` so that the port imports
nothing of the JAX package: the deck parser, Plot3D reader, restart and
function-file writers and readers and the point-cloud loader.  Only
imports (and, in ``output.py``, the Physics calls on torch tensors)
differ from the originals; keep them diffable."""
