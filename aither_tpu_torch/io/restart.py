"""Binary restart (.rst) files, byte-compatible with the reference
(reference: src/output.cpp:591-754 WriteRestart / :756-900 ReadRestart).

Layout (little-endian):
  int32 numSols (1, or 2 for BDF2)
  int32 iteration
  int32 numEqns
  int32 numSpecies
  per species: uint64 nameLen + name chars
  float64[numEqns] first-iteration L2 residual (normalization state)
  int32 numBlocks; per block: int32 ni, nj, nk, numVars
  per block, k-slow/i-fast, per cell: numVars float64 dimensional values
    ordered [density, vel_x, vel_y, vel_z, pressure, (tke, sdr), mf_s...]
  if numSols == 2: same layout again with conserved time n-1 data.
"""

from __future__ import annotations

import struct

import numpy as np


def write_restart(path, deck, phys, iteration, l2_first, blocks_prim,
                  blocks_cons_nm1=None, mu_ref=1.0):
    """blocks_prim: list of (neq, ni, nj, nk) nondim primitive interior
    arrays (numpy)."""
    num_sols = 2 if blocks_cons_nm1 is not None else 1
    a, r = deck.a_ref, deck.r_ref
    ns = phys.ns
    names = deck.species_names
    num_vars = 5 + (2 if phys.nturb else 0) + ns

    with open(path, "wb") as f:
        f.write(struct.pack("<4i", num_sols, iteration, phys.neq, ns))
        for name in names:
            f.write(struct.pack("<Q", len(name)))
            f.write(name.encode())
        f.write(np.asarray(l2_first, dtype="<f8").tobytes())
        f.write(struct.pack("<i", len(blocks_prim)))
        for blk in blocks_prim:
            _, ni, nj, nk = blk.shape
            f.write(struct.pack("<4i", ni, nj, nk, num_vars))
        for blk in blocks_prim:
            f.write(_dim_prim_record(blk, phys, a, r, mu_ref).tobytes())
        if num_sols == 2:
            for blk in blocks_cons_nm1:
                f.write(_dim_cons_record(blk, phys, a, r, mu_ref).tobytes())


def _var_stack_prim(blk, phys, a, r, mu_ref):
    ns = phys.ns
    rho = blk[:ns].sum(axis=0)
    out = [rho * r,
           blk[phys.mx] * a, blk[phys.my] * a, blk[phys.mz] * a,
           blk[phys.ie] * r * a * a]
    if phys.nturb:
        out.append(blk[phys.it] * a * a)
        out.append(blk[phys.it + 1] * a * a * r / mu_ref)
    for s in range(ns):
        out.append(blk[s] / rho)
    return np.stack(out)


def _dim_prim_record(blk, phys, a, r, mu_ref):
    vars_ = _var_stack_prim(np.asarray(blk), phys, a, r, mu_ref)
    # (nv, ni, nj, nk) -> k-slow, j, i, var-fast
    return np.ascontiguousarray(vars_.transpose(3, 2, 1, 0), dtype="<f8")


def _dim_cons_record(blk, phys, a, r, mu_ref):
    ns = phys.ns
    blk = np.asarray(blk)
    out = [blk[:ns].sum(axis=0) * r,
           blk[phys.mx] * a * r, blk[phys.my] * a * r, blk[phys.mz] * a * r,
           blk[phys.ie] * a * a * r]
    if phys.nturb:
        out.append(blk[phys.it] * a * a * r)
        out.append(blk[phys.it + 1] * a * a * r * r / mu_ref)
    rho = blk[:ns].sum(axis=0)
    for s in range(ns):
        out.append(blk[s] / rho)
    vars_ = np.stack(out)
    return np.ascontiguousarray(vars_.transpose(3, 2, 1, 0), dtype="<f8")


def read_restart(path):
    """Returns dict with iteration, l2_first, species, and per block the raw
    dimensional variable arrays (nv, ni, nj, nk) (+ cons n-1 if present)."""
    with open(path, "rb") as f:
        raw = f.read()
    off = 0
    num_sols, iteration, neq, ns = struct.unpack_from("<4i", raw, off)
    off += 16
    species = []
    for _ in range(ns):
        (ln,) = struct.unpack_from("<Q", raw, off)
        off += 8
        species.append(raw[off:off + ln].decode())
        off += ln
    l2_first = np.frombuffer(raw, "<f8", neq, off).copy()
    off += 8 * neq
    (nblk,) = struct.unpack_from("<i", raw, off)
    off += 4
    dims = []
    for _ in range(nblk):
        ni, nj, nk, nv = struct.unpack_from("<4i", raw, off)
        off += 16
        dims.append((ni, nj, nk, nv))
    out_blocks = []
    for ni, nj, nk, nv in dims:
        n = ni * nj * nk * nv
        arr = np.frombuffer(raw, "<f8", n, off).copy()
        off += 8 * n
        out_blocks.append(arr.reshape(nk, nj, ni, nv).transpose(3, 2, 1, 0))
    out_nm1 = None
    if num_sols == 2:
        out_nm1 = []
        for ni, nj, nk, nv in dims:
            n = ni * nj * nk * nv
            arr = np.frombuffer(raw, "<f8", n, off).copy()
            off += 8 * n
            out_nm1.append(arr.reshape(nk, nj, ni, nv).transpose(3, 2, 1, 0))
    return dict(num_sols=num_sols, iteration=iteration, neq=neq,
                species=species, l2_first=l2_first, blocks=out_blocks,
                blocks_nm1=out_nm1)


def cons_from_restart(rec_block, phys, deck, mu_ref=1.0):
    """dimensional conserved record (time n-1) -> nondim conserved array."""
    a, r = deck.a_ref, deck.r_ref
    nv, ni, nj, nk = rec_block.shape
    ns = phys.ns
    cons = np.zeros((phys.neq, ni, nj, nk))
    rho = rec_block[0] / r
    base = 5 + (2 if phys.nturb else 0)
    for s in range(ns):
        mf = rec_block[base + s] if ns > 1 else np.ones_like(rho)
        cons[s] = rho * mf
    cons[phys.mx] = rec_block[1] / (a * r)
    cons[phys.my] = rec_block[2] / (a * r)
    cons[phys.mz] = rec_block[3] / (a * r)
    cons[phys.ie] = rec_block[4] / (r * a * a)
    if phys.nturb:
        cons[phys.it] = rec_block[5] / (a * a * r)
        cons[phys.it + 1] = rec_block[6] * mu_ref / (a * a * r * r)
    return cons


def prim_from_restart(rec_block, phys, deck, mu_ref=1.0):
    """dimensional restart variables -> nondim primitive (neq, ni, nj, nk)."""
    a, r = deck.a_ref, deck.r_ref
    nv, ni, nj, nk = rec_block.shape
    ns = phys.ns
    prim = np.zeros((phys.neq, ni, nj, nk))
    rho = rec_block[0] / r
    base = 5 + (2 if phys.nturb else 0)
    for s in range(ns):
        mf = rec_block[base + s] if ns > 1 else np.ones_like(rho)
        prim[s] = rho * mf
    prim[phys.mx] = rec_block[1] / a
    prim[phys.my] = rec_block[2] / a
    prim[phys.mz] = rec_block[3] / a
    prim[phys.ie] = rec_block[4] / (r * a * a)
    if phys.nturb:
        prim[phys.it] = rec_block[5] / (a * a)
        prim[phys.it + 1] = rec_block[6] * mu_ref / (a * a * r)
    return prim
