"""Point-cloud initial conditions (icState file=...).

Replicates the reference's cloud format and nondimensionalization
(reference: src/utility.cpp:521-600 CalcTreeFromCloud): line 1 = number of
points, line 2 = species names, then rows of
``x y z rho u v w p tke omega mf...`` in SI units.  Cells take the state of
the nearest cloud point (reference: procBlock.cpp:287-320 uses a k-d tree;
so does this copy of ``aither_tpu/io/cloud.py``: ``utils/native.py``).
"""

from __future__ import annotations

import numpy as np


def load_cloud(path: str, deck, phys):
    """Returns (points (np,3) nondim, states (neq, np) nondim)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    npts = int(lines[0].split()[0])
    species = lines[1].split()
    sp_idx = [deck.species_index(s) for s in species]
    rows = np.array([[float(v) for v in ln.split()]
                     for ln in lines[2:2 + npts]])
    if rows.shape[1] != 10 + len(species):
        raise ValueError(
            f"cloud file {path}: expected {10 + len(species)} columns, got "
            f"{rows.shape[1]}")
    a, r, l = deck.a_ref, deck.r_ref, deck.l_ref
    pts = rows[:, 0:3] / l
    rho = rows[:, 3] / r
    vel = rows[:, 4:7] / a
    p = rows[:, 7] / (r * a * a)
    tke = rows[:, 8] / (a * a)
    omega = rows[:, 9] * phys.mu_mix_ref / (r * a * a)
    mf = rows[:, 10:]

    neq = phys.neq
    states = np.zeros((neq, npts))
    for col, ind in enumerate(sp_idx):
        states[ind] = rho * mf[:, col]
    states[phys.mx:phys.mx + 3] = vel.T
    states[phys.ie] = p
    if phys.nturb:
        states[phys.it] = tke
        states[phys.it + 1] = omega
    return pts, states


def nearest_states(points, states, centers):
    """centers (..., 3) -> (neq, ...) nearest-neighbor states (native
    k-d tree, reference: procBlock.cpp:287-320)."""
    from ..utils.native import nearest_neighbors
    shp = centers.shape[:-1]
    flat = np.ascontiguousarray(centers.reshape(-1, 3))
    idx, _ = nearest_neighbors(points, flat)
    out = states[:, idx]
    return out.reshape((states.shape[0],) + shp)
