"""Parallel layers.  ``decompose.py``: the cubic decomposition, copied
from ``aither_tpu/parallel/`` so that the port imports nothing of the JAX
package (only imports differ from the original; keep it diffable).
``shard.py`` (which rank owns which block) and ``distributed.py`` (one
process per rank over ``torch.distributed``, rank 0 reading the case,
``launch_local``) are the port's own: its multi-rank runs."""
