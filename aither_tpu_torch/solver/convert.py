"""State carried across from the JAX package (or any numpy source).

The JAX solver's per-block padded primitive arrays (``Solver.prims``),
time-n conserved interiors (``Solver.cons_n``) and, for a multilevel
(bdf2) deck, time n-1 ones (``Solver.cons_nm1``), and the nonreflecting
boundaries' carry (``Solver.bc_aux``: dt and the cell pressure and
velocity gradients of the previous iteration), fetched to numpy, become
the port's tensors here (``Solver.set_state``), so both packages can start
from one state; on the ranks of a multi-rank run ``scatter_state`` hands
each rank its own blocks of rank 0's whole-case state.
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


def bc_aux_from_numpy(bc_aux: dict, device, dtype=torch.float64) -> dict:
    """{block: {'dt', 'pgrad', 'vgrad': numpy}} -> the same with tensors
    on device"""
    return {int(k): {name: torch.tensor(np.asarray(v), dtype=dtype,
                                        device=device)
                     for name, v in aux.items()}
            for k, aux in bc_aux.items()}


def scatter_state(comm, owners, *dicts):
    """Rank 0's whole-case {block: ...} dicts (None where not given) as
    each rank's own blocks of them: rank 0 sends rank r the entries of the
    blocks ``owners`` gives r; the other ranks pass None for every dict.
    Returns the rank's dicts, in order."""
    parts = None
    if comm.rank == 0:
        parts = [tuple(None if d is None else
                       {int(b): v for b, v in d.items() if owners[int(b)] == r}
                       for d in dicts) for r in range(comm.world)]
    return comm.scatter_objects(parts)
