"""Geometric multigrid (FAS) for the implicit linear solve: the coarse
levels and the transfer operators between them.

Port of ``aither_tpu/solver/multigrid.py`` (reference:
src/mgSolution.cpp:131-244 CycleAtLevel / Relax, src/gridLevel.cpp:440-640
Coarsen / Restriction / Prolongation, src/procBlock.cpp:6471-6607
GetCoarseMeshAndBCs, include/gridLevel.hpp:160-215 BlockProlongation):

- coarsening keeps every other node plus all boundary-surface indices;
  boundary surface extents are remapped to the kept-index positions, and
  each coarse level is a Case of its own (``case.assemble_case``);
- fine->coarse state/update restriction is volume-weighted; the matrix
  residual restriction is a plain sum;
- prolongation converts the coarse correction to nodal values (interior
  cells only, with the reference's corner/edge/interior 1, 1/2, 1/8
  normalisation) and trilinearly interpolates to fine cell centres.

The cycle itself (forcing, V/W recursion, the diagonal carry) lives in the
driver (``Solver._mg_cycle``).

What differs from the JAX package: the prolongation coefficients are
computed for all fine cells at once in numpy (the JAX package loops over
the fine cells in Python), with the same operations per cell in the same
order (a 3-vector dot product is the left-to-right sum of its three
products), so they agree bit for bit.  The restriction is a gather, not a
scatter-add: a coarse cell owns at most two fine cells per axis (the kept
nodes are at most two apart), so each coarse cell adds its up to eight
fine cells in the fine cells' row-major order, the order of a sequential
scatter, and the masked slots add an exact zero.  That is deterministic
on the card, with no floating-point atomics whose order changes from run
to run.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# host-side coarsening


def _is_surface_boundary(bc, d: str, ind: int) -> bool:
    """(reference: boundaryConditions.cpp:1227-1248)"""
    lo = {"i": "imin", "j": "jmin", "k": "kmin"}[d]
    hi = {"i": "imax", "j": "jmax", "k": "kmax"}[d]
    return any(getattr(s, lo) == ind or getattr(s, hi) == ind
               for s in bc.surfaces)


def _kept_indices(bc, d: str, nnode: int):
    """fine node indices kept on the coarse mesh
    (reference: procBlock.cpp:6477-6529)."""
    kept = []
    since_last = 0
    for ii in range(nnode):
        if _is_surface_boundary(bc, d, ii):
            kept.append(ii)
            since_last = 0
        elif since_last > 0:
            kept.append(ii)
            since_last = 0
        else:
            since_last += 1
    return kept


def _remap_surfaces(bc, kept):
    """Remap surface node extents to coarse indices (BoundarySurface is
    frozen, so rebuild)."""
    maps = {d: {old: new for new, old in enumerate(kept[d])} for d in "ijk"}
    surfs = [dataclasses.replace(
        s, imin=maps["i"][s.imin], imax=maps["i"][s.imax],
        jmin=maps["j"][s.jmin], jmax=maps["j"][s.jmax],
        kmin=maps["k"][s.kmin], kmax=maps["k"][s.kmax])
        for s in bc.surfaces]
    return dataclasses.replace(bc, num_i=len(kept["i"]),
                               num_j=len(kept["j"]), num_k=len(kept["k"]),
                               surfaces=surfs)


def _cell_map(kept_d, n_f: int) -> np.ndarray:
    """coarse cell of each fine cell along one axis: the last kept node at
    or below the cell's lower node (reference: procBlock.cpp:6545-6585)"""
    c = np.searchsorted(np.asarray(kept_d), np.arange(n_f), side="right")
    return np.where(c != 0, c - 1, c).astype(np.int64)


@dataclasses.dataclass
class LevelMap:
    """fine->coarse transfer data for one block: host arrays (the JAX
    package's ``LevelMap``) and their device forms (``dev``)."""

    mi: np.ndarray          # (ni,) coarse cell index of each fine i
    mj: np.ndarray          # (nj,)
    mk: np.ndarray          # (nk,)
    volfac: np.ndarray      # (ni,nj,nk) fine volume / coarse-cell sum
    prolong: np.ndarray     # (7, ni,nj,nk) trilinear coefficients
    node_factor: np.ndarray  # (cni+1, cnj+1, cnk+1) cell->node normalization
    dev: dict = None        # tensors on the case's device (_device_form)


def _lin_coeff(x0, x1, x):
    """``_lin_coeff`` of the JAX package over the leading axes: x0, x1, x
    (..., 3)"""
    d = x1 - x0
    den = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    e = (x - x0) * d
    num = e[..., 0] + e[..., 1] + e[..., 2]
    pos = den > 0.0
    return np.where(pos, num / np.where(pos, den, 1.0), 0.0)


def _trilinear_coeffs(nodes8, x):
    """(7, ...) coefficients of the points x (..., 3) in the hexahedra of
    nodes8 (8 arrays (..., 3)) (reference: utility.cpp:633-659)"""
    c = np.empty((7,) + x.shape[:-1])
    lerp = (lambda a, b, t: a + t[..., None] * (b - a))
    c[0] = _lin_coeff(nodes8[0], nodes8[4], x)
    x04 = lerp(nodes8[0], nodes8[4], c[0])
    c[1] = _lin_coeff(nodes8[1], nodes8[5], x)
    x15 = lerp(nodes8[1], nodes8[5], c[1])
    c[2] = _lin_coeff(nodes8[2], nodes8[6], x)
    x26 = lerp(nodes8[2], nodes8[6], c[2])
    c[3] = _lin_coeff(nodes8[3], nodes8[7], x)
    x37 = lerp(nodes8[3], nodes8[7], c[3])
    c[4] = _lin_coeff(x04, x15, x)
    x0415 = lerp(x04, x15, c[4])
    c[5] = _lin_coeff(x26, x37, x)
    x2637 = lerp(x26, x37, c[5])
    c[6] = _lin_coeff(x0415, x2637, x)
    return c


def _node_factor(cni: int, cnj: int, cnk: int) -> np.ndarray:
    """cell->node normalization (reference: utility.hpp:306-330 without
    ghosts: corner nodes x1, edge nodes x1/2, all others x1/8)"""
    nf = np.full((cni + 1, cnj + 1, cnk + 1), 0.125)
    ext = [np.isin(np.arange(n + 1), [0, n]).astype(int)
           for n in (cni, cnj, cnk)]
    n_ext = (ext[0][:, None, None] + ext[1][None, :, None]
             + ext[2][None, None, :])
    nf[n_ext == 2] = 0.5
    nf[n_ext == 3] = 1.0
    return nf


def _gather_slots(m: np.ndarray, nc: int, device):
    """for one axis, the fine cells of each coarse cell as slots: a list
    over the slot number of (fine index per coarse cell, whether the
    coarse cell has that slot), fine cells in increasing order"""
    first = np.searchsorted(m, np.arange(nc), side="left")
    count = np.bincount(m, minlength=nc)
    slots = []
    for o in range(int(count.max())):
        valid = o < count
        idx = np.where(valid, first + o, first)
        slots.append((torch.as_tensor(idx, device=device),
                      torch.as_tensor(valid, device=device)))
    return slots


def _device_form(lm: LevelMap, dtype, device) -> dict:
    """the transfer data of one block as tensors on ``device``"""
    cshape = tuple(n - 1 for n in lm.node_factor.shape)
    as_t = (lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=device))
    return dict(
        cshape=cshape,
        slots=[_gather_slots(m, n, device)
               for m, n in zip((lm.mi, lm.mj, lm.mk), cshape)],
        maps=[torch.as_tensor(m, device=device)
              for m in (lm.mi, lm.mj, lm.mk)],
        volfac=as_t(lm.volfac), prolong=as_t(lm.prolong),
        node_factor=as_t(lm.node_factor))


def coarsen_case(case):
    """Build the next-coarser Case + transfer maps from `case`
    (reference: gridLevel::Coarsen).  Needs ``case.grids`` / ``case.bcs``
    (kept by ``case.assemble_case``).  A rank of a multi-rank run coarsens
    the whole grid on the host, owns the same blocks on every level (its
    coarse Case has its own rank exchange) and builds the transfer maps
    of its own blocks only: the others' entries are None."""
    from .case import assemble_case

    coarse_grids = []
    coarse_bcs = []
    maps = []
    own = {b.index for b in case.blocks}
    for b, (nodes, bc) in enumerate(zip(case.grids, case.bcs)):
        kept = {d: _kept_indices(bc, d, nodes.shape[a])
                for a, d in enumerate("ijk")}
        cn = nodes[np.ix_(kept["i"], kept["j"], kept["k"])]
        coarse_grids.append(cn)
        coarse_bcs.append(_remap_surfaces(bc, kept))
        if b not in own:
            maps.append(None)
            continue

        ni, nj, nk = (nodes.shape[0] - 1, nodes.shape[1] - 1,
                      nodes.shape[2] - 1)
        mi = _cell_map(kept["i"], ni)
        mj = _cell_map(kept["j"], nj)
        mk = _cell_map(kept["k"], nk)
        ci = np.broadcast_to(mi[:, None, None], (ni, nj, nk))
        cj = np.broadcast_to(mj[None, :, None], (ni, nj, nk))
        ck = np.broadcast_to(mk[None, None, :], (ni, nj, nk))

        # volume weighting factor
        blk = case.block(b)
        g = blk.g
        vol = blk.geom_host["vol"][g:g + ni, g:g + nj, g:g + nk]
        cni = len(kept["i"]) - 1
        cnj = len(kept["j"]) - 1
        cnk = len(kept["k"]) - 1
        volsum = np.zeros((cni, cnj, cnk))
        np.add.at(volsum, (ci, cj, ck), vol)
        volfac = vol / volsum[ci, cj, ck]

        # prolongation coefficients from fine centers in coarse node cells,
        # nodes d0..d7 = (i, j, k) + (a, b, c) with index a + 2b + 4c
        centers = np.moveaxis(blk.geom_host["center"], 0, -1)[
            g:g + ni, g:g + nj, g:g + nk]
        n8 = [cn[ci + a, cj + bb, ck + c]
              for c in (0, 1) for bb in (0, 1) for a in (0, 1)]
        prolong = _trilinear_coeffs(n8, centers)

        lm = LevelMap(mi=mi, mj=mj, mk=mk, volfac=volfac, prolong=prolong,
                      node_factor=_node_factor(cni, cnj, cnk))
        lm.dev = _device_form(lm, case.dtype, case.device)
        maps.append(lm)

    total = sum((gr.shape[0] - 1) * (gr.shape[1] - 1) * (gr.shape[2] - 1)
                for gr in coarse_grids)
    coarse = assemble_case(case.deck, case.phys, coarse_grids, coarse_bcs,
                           case.dtype, case.device, total, owners=case.owners,
                           comm=case.comm)
    return coarse, maps


def build_levels(case, n_levels: int):
    """[finest ... coarsest] cases + per-transition maps."""
    levels = [case]
    transfer = []
    for _ in range(n_levels - 1):
        coarse, maps = coarsen_case(levels[-1])
        levels.append(coarse)
        transfer.append(maps)
    return levels, transfer


# ---------------------------------------------------------------------------
# transfer operators (tensor code on the case's device)


def restrict_sum(fine, lm: LevelMap, coarse_shape):
    """Plain-sum restriction of an interior (neq, ni,nj,nk) field to the
    coarse interior (neq, cni,cnj,cnk): each coarse cell adds its fine
    cells in their row-major order (module docstring)."""
    dev = lm.dev
    if tuple(coarse_shape) != dev["cshape"]:
        raise ValueError(f"coarse shape {coarse_shape}, the map's "
                         f"{dev['cshape']}")
    out = None
    for (ii, vi), (jj, vj), (kk, vk) in itertools.product(*dev["slots"]):
        part = fine[:, ii[:, None, None], jj[None, :, None],
                    kk[None, None, :]]
        valid = vi[:, None, None] & vj[None, :, None] & vk[None, None, :]
        part = torch.where(valid[None], part, 0.0)
        out = part if out is None else out + part
    return out


def restrict_weighted(fine, lm: LevelMap, coarse_shape):
    """Volume-weighted restriction of an interior (neq, ni,nj,nk) field."""
    return restrict_sum(lm.dev["volfac"][None] * fine, lm, coarse_shape)


def prolong(coarse_corr, lm: LevelMap):
    """Coarse interior correction (neq, cni,cnj,cnk) -> fine interior via
    cell->node conversion + trilinear interpolation
    (reference: gridLevel.hpp:160-215)."""
    dev = lm.dev
    neq, cni, cnj, cnk = coarse_corr.shape
    nodes = torch.zeros((neq, cni + 1, cnj + 1, cnk + 1),
                        dtype=coarse_corr.dtype, device=coarse_corr.device)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                nodes[:, di:di + cni, dj:dj + cnj, dk:dk + cnk] += coarse_corr
    nodes = nodes * dev["node_factor"][None]
    mi, mj, mk = dev["maps"]
    # d[a + 2b + 4c]: the node (i, j, k) + (a, b, c) of the fine cell's
    # coarse cell, the reference's d0..d7
    d = [nodes[:, (mi + a)[:, None, None], (mj + b)[None, :, None],
               (mk + c)[None, None, :]]
         for c in (0, 1) for b in (0, 1) for a in (0, 1)]
    co = dev["prolong"]

    def lin(a, b, c):
        return (1.0 - c) * a + c * b

    d04 = lin(d[0], d[4], co[0][None])
    d15 = lin(d[1], d[5], co[1][None])
    d26 = lin(d[2], d[6], co[2][None])
    d37 = lin(d[3], d[7], co[3][None])
    d0415 = lin(d04, d15, co[4][None])
    d2637 = lin(d26, d37, co[5][None])
    return lin(d0415, d2637, co[6][None])
