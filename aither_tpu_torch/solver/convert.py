"""State carried across from the JAX package (or any numpy source).

The JAX solver's per-block padded primitive arrays (``Solver.prims``) and
time-n conserved interiors (``Solver.cons_n``), fetched to numpy, become
the port's tensors here, so both packages can start from one state.
Geometry is not converted: both packages build it with the same host code.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(arrays: dict, device, dtype=torch.float64) -> dict:
    """{block: numpy array} -> {block: tensor on device} (copies: the
    port updates its state in place)."""
    return {int(k): torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in arrays.items()}
