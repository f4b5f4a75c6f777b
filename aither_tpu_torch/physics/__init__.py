"""Physics of the port.  ``fluid.py`` is a copy of
``aither_tpu/physics/fluid.py`` (the species database the deck parser
reads); keep it diffable against the original.  ``models.py`` and
``chemistry.py`` port the JAX package's modules of the same names."""
