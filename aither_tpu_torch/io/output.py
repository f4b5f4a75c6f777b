"""Plot3D solution output: cell-center grids, .fun function files, .p3d
ParaView meta files (reference: src/output.cpp:55-1005).

All binary files are raw little-endian (no Fortran markers), dimensional
values, i-fastest ordering, matching the reference writers so ParaView
workflows used with the reference work unchanged.

Copy of ``aither_tpu/io/output.py``.  What differs: ``variable_field`` and
``wall_variable_field`` call the port's ``physics.models.Physics`` on
float64 CPU tensors (``_t``) and return numpy (``_np``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _t(x):
    """float64 CPU tensor of a numpy array (shares its memory)"""
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def _np(x):
    """numpy of a Physics result: a tensor or a float"""
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _write_block_dims(f, dims, num_vars=0):
    f.write(np.int32(len(dims)).tobytes())
    for d in dims:
        rec = list(d[:3]) + ([num_vars] if num_vars > 0 else [])
        f.write(np.asarray(rec, dtype="<i4").tobytes())


def write_cell_center(path, centers, l_ref):
    """centers: list of (ni, nj, nk, 3) cell-center arrays (nondim)."""
    with open(path, "wb") as f:
        _write_block_dims(f, [c.shape[:3] for c in centers])
        for c in centers:
            for n in range(3):
                f.write(np.ascontiguousarray(
                    (c[..., n] * l_ref).transpose(2, 1, 0),
                    dtype="<f8").tobytes())


def variable_field(name, prim, phys, deck, aux=None):
    """dimensional output field for one variable from nondim primitives
    (reference: output.cpp:209-439)."""
    a, r, t_ref, l_ref = (deck.a_ref, deck.r_ref, deck.t_ref, deck.l_ref)
    ns = phys.ns
    rho = prim[:ns].sum(axis=0)
    mf = prim[:ns] / rho

    def temperature():
        return _np(phys.temperature(_t(prim[phys.ie]), _t(prim[:ns])))

    if name == "density":
        return rho * r
    if name == "vel_x":
        return prim[phys.mx] * a
    if name == "vel_y":
        return prim[phys.my] * a
    if name == "vel_z":
        return prim[phys.mz] * a
    if name == "pressure":
        return prim[phys.ie] * r * a * a
    if name == "temperature":
        # nodal blocks carry the cell-averaged temperature field (reference
        # reads temperature_, not T(state): output.cpp:258)
        if aux is not None and "temperature" in aux:
            return np.asarray(aux["temperature"]) * t_ref
        return temperature() * t_ref
    if name == "mach":
        vel = prim[phys.mx:phys.mx + 3]
        vmag = np.sqrt((vel * vel).sum(axis=0))
        return vmag / _np(phys.sos(_t(prim[phys.ie]), _t(prim[:ns])))
    if name == "sos":
        return _np(phys.sos(_t(prim[phys.ie]), _t(prim[:ns]))) * a
    if name == "viscosity":
        if aux is not None and "viscosity" in aux:
            return np.asarray(aux["viscosity"]) * phys.mu_mix_ref
        mu = _np(phys.viscosity(_t(temperature()), _t(mf)))
        return mu * phys.mu_mix_ref
    if name == "tke":
        return prim[phys.it] * a * a
    if name == "sdr":
        return prim[phys.it + 1] * a * a * r / phys.mu_mix_ref
    if name == "wallDistance" and aux is not None and "wall_dist" in aux:
        return aux["wall_dist"] * l_ref
    if name == "turbulentViscosity" and aux is not None and "mut" in aux:
        return aux["mut"] * phys.mu_mix_ref
    if name == "viscosityRatio" and aux is not None and "mut" in aux:
        mu = (np.asarray(aux["viscosity"]) if "viscosity" in aux
              else _np(phys.viscosity(_t(temperature()), _t(mf))))
        return aux["mut"] / mu
    if name.startswith("mf_"):
        sp = name[3:]
        idx = deck.species_index(sp)
        return np.asarray(mf[idx])
    if name == "rank":
        # owning rank of each cell under the decomposition (reference:
        # output.cpp:278-280 SplitBlockNumber -> decomposition::Rank);
        # the driver supplies the recombined per-cell field
        if aux is not None and "rank" in aux:
            return np.asarray(aux["rank"], np.float64)
        return np.zeros_like(np.asarray(rho))
    if name == "globalPosition":
        # owning block's position in the global (post-split) block vector
        # (reference: output.cpp:281-283 procBlock::GlobalPos)
        if aux is not None and "globalPosition" in aux:
            return np.asarray(aux["globalPosition"], np.float64)
        return np.zeros_like(np.asarray(rho))
    if name == "cp":
        # cp/cv read the averaged temperature field on nodal blocks
        # (reference: output.cpp:271-281)
        t_cp = (np.asarray(aux["temperature"])
                if aux is not None and "temperature" in aux
                else temperature())
        cp = _np(phys.mix(phys.species_cp(_t(t_cp)), _t(mf)))
        return cp * a * a / t_ref
    if name == "cv":
        t_cv = (np.asarray(aux["temperature"])
                if aux is not None and "temperature" in aux
                else temperature())
        cv = _np(phys.mix(phys.species_cv(_t(t_cv)), _t(mf)))
        return cv * a * a / t_ref
    if name == "energy":
        e = _np(phys.mix(phys.species_energy(_t(temperature())), _t(mf)))
        vel = prim[phys.mx:phys.mx + 3]
        return (e + 0.5 * (vel * vel).sum(axis=0)) * a * a
    if name == "enthalpy":
        h = _np(phys.mix(phys.species_enthalpy(_t(temperature())),
                         _t(mf)))
        vel = prim[phys.mx:phys.mx + 3]
        return (h + 0.5 * (vel * vel).sum(axis=0)) * a * a
    if name == "dt" and aux is not None and "dt" in aux:
        return aux["dt"] * l_ref / a
    if name in ("f1", "f2") and aux is not None and name in aux:
        return np.asarray(aux[name])
    # gradient components (reference: output.cpp:309-383)
    comp = {"x": 0, "y": 1, "z": 2}
    vcomp = {"u": 0, "v": 1, "w": 2}
    cellavg = (aux or {}).get("cellavg")
    if name.startswith("velGrad_") and cellavg is not None:
        cv_, cx = name[8], name[9]
        # cellavg["vel"][a][b] = d v_b / d x_a
        return np.asarray(cellavg["vel"][comp[cx], vcomp[cv_]]) * a / l_ref
    if name.startswith("tempGrad_") and cellavg is not None:
        return np.asarray(cellavg["temp"][comp[name[-1]]]) * t_ref / l_ref
    if name.startswith("densityGrad_") and cellavg is not None:
        return np.asarray(cellavg["rho"][comp[name[-1]]]) * r / l_ref
    if name.startswith("pressGrad_") and cellavg is not None:
        return np.asarray(cellavg["press"][comp[name[-1]]]) * r * a * a / l_ref
    if name.startswith("tkeGrad_") and cellavg is not None:
        return np.asarray(cellavg["tke"][comp[name[-1]]]) * a * a / l_ref
    if name.startswith("omegaGrad_") and cellavg is not None:
        return np.asarray(cellavg["omega"][comp[name[-1]]]) \
            * a * a * r / (phys.mu_mix_ref * l_ref)
    if name.startswith("resid_") and aux is not None and "resid" in aux:
        # (reference: output.cpp:384-411)
        which = name[6:]
        eq = {"mass": 0, "mom_x": ns, "mom_y": ns + 1, "mom_z": ns + 2,
              "energy": ns + 3, "tke": ns + 4, "sdr": ns + 5}[which]
        val = np.asarray(aux["resid"][eq])
        if which == "mass":
            return val * r * a * l_ref * l_ref
        if which in ("mom_x", "mom_y", "mom_z"):
            return val * r * a * a * l_ref * l_ref
        if which in ("energy", "tke"):
            return val * r * a ** 3 * l_ref * l_ref
        return val * r * r * a ** 4 * l_ref * l_ref / phys.mu_mix_ref
    if aux is not None and name in aux:
        return np.asarray(aux[name])
    return np.zeros_like(np.asarray(rho))


# wall output variable scalings (reference: output.cpp:472-560)
def wall_variable_field(name, wd, phys, deck):
    a, r, t_ref, l_ref = (deck.a_ref, deck.r_ref, deck.t_ref, deck.l_ref)
    mu_ref = phys.mu_mix_ref
    inv_scaling = 1.0 / phys.nondim_scaling
    if name == "yplus":
        return np.asarray(wd["yplus"])
    if name == "shearStress":
        tau = np.asarray(wd["tau"])
        return np.sqrt((tau * tau).sum(axis=0)) \
            * inv_scaling * mu_ref * a / l_ref
    if name == "viscosityRatio":
        return np.asarray(wd["mut"]) / (np.asarray(wd["mu"]) + 1.0e-30)
    if name == "heatFlux":
        return np.asarray(wd["q"]) * mu_ref * t_ref / l_ref
    if name == "frictionVelocity":
        return np.asarray(wd["u_star"]) * a
    if name == "density":
        return np.asarray(wd["rho"]) * r
    if name == "pressure":
        rho = np.asarray(wd["rho"])
        t = np.asarray(wd["t"])
        mfw = torch.ones((phys.ns,) + rho.shape,
                         dtype=torch.float64) / phys.ns \
            if "mf" not in wd else _t(wd["mf"])
        p = _np(phys.pressure_rt(_t(rho)[None] * mfw, _t(t)))
        return p * r * a * a
    if name == "temperature":
        return np.asarray(wd["t"]) * t_ref
    if name == "viscosity":
        return np.asarray(wd["mu"]) * mu_ref * inv_scaling
    if name == "tke":
        return np.asarray(wd["tke"]) * a * a
    if name == "sdr":
        return np.asarray(wd["sdr"]) * a * a * r / mu_ref
    raise ValueError(f"unknown wall output variable {name!r}")


def write_wall_files(sim_root, grid_name, iteration, case, wall_blocks,
                     var_names):
    """Wall-face grid + fun + meta files (reference: output.cpp:146-207
    WriteWallGrid, :472-560 WriteWallFun, :963-1005 WriteWallMeta).

    wall_blocks: list of (surface_spec, face_centers (n1,n2,3) nondim,
    wall_data dict of (n1,n2) arrays)."""
    deck = case.deck
    phys = case.phys
    if not wall_blocks:
        return

    def to3d(spec, arr):
        """(t1, t2) transverse field -> (di, dj, dk) with the surface's
        constant axis of extent 1 (reference: WriteBlockDims over
        boundarySurface ranges, output.cpp:496-506)."""
        return np.expand_dims(arr, axis=spec.axis)

    dims = [to3d(spec, fc[..., 0]).shape for _, spec, fc, _ in wall_blocks]
    # wall-face center grid (written once per run alongside the fun files)
    grid_path = f"{sim_root}_wall_center.xyz"
    if not os.path.isfile(grid_path):
        with open(grid_path, "wb") as f:
            _write_block_dims(f, dims)
            for _, spec, fc, _ in wall_blocks:
                for n in range(3):
                    f.write(np.ascontiguousarray(
                        to3d(spec, fc[..., n] * deck.l_ref).transpose(2, 1, 0),
                        dtype="<f8").tobytes())
    # data layout replicates the reference exactly: per parent block,
    # VARIABLE-major with that block's wall surfaces inner
    # (output.cpp:505-560: for blk / for var / for surface)
    fun_path = f"{sim_root}_{iteration}_wall_center.fun"
    parents = []
    for bi, *_ in wall_blocks:
        if bi not in parents:
            parents.append(bi)
    with open(fun_path, "wb") as f:
        _write_block_dims(f, dims, num_vars=len(var_names))
        for bi in parents:
            for name in var_names:
                for bj, spec, fc, wd in wall_blocks:
                    if bj != bi:
                        continue
                    field = wall_variable_field(name, wd, phys, deck)
                    f.write(np.ascontiguousarray(
                        to3d(spec, field).transpose(2, 1, 0),
                        dtype="<f8").tobytes())


def write_fun_file(path, var_names, blocks_prim, phys, deck, aux_blocks=None):
    """blocks_prim: list of (neq, ni, nj, nk) nondim interior primitives."""
    var_names = list(var_names)
    with open(path, "wb") as f:
        _write_block_dims(f, [b.shape[1:] for b in blocks_prim],
                          num_vars=len(var_names))
        for bi, prim in enumerate(blocks_prim):
            aux = aux_blocks[bi] if aux_blocks else None
            for name in var_names:
                field = np.asarray(variable_field(name, np.asarray(prim),
                                                  phys, deck, aux))
                f.write(np.ascontiguousarray(
                    field.transpose(2, 1, 0), dtype="<f8").tobytes())


def read_fun_file(path, num_vars=None):
    """Read a Plot3D .fun function file written by write_fun_file or the
    reference (reference: output.cpp:209-230 WriteBlockDims layout).
    Returns (dims, [ (nvars, ni, nj, nk) arrays ])."""
    with open(path, "rb") as f:
        nblk = int(np.frombuffer(f.read(4), "<i4")[0])
        hdr = np.frombuffer(f.read(4 * 4 * nblk), "<i4").reshape(nblk, 4)
        blocks = []
        for b in range(nblk):
            ni, nj, nk, nv = (int(x) for x in hdr[b])
            data = np.frombuffer(f.read(8 * ni * nj * nk * nv), "<f8")
            arr = data.reshape(nv, nk, nj, ni).transpose(0, 3, 2, 1)
            blocks.append(arr)
    return hdr[:, :3], blocks


# ---------------------------------------------------------------------------
# nodal output (reference: output.cpp:452-470 WriteNodeFun,
# utility.hpp:186-334 ConvertCellToNode, procBlock.cpp:6607-6847 CellToNode,
# procBlock.cpp:2716-2755 AssignCornerGhostCells)


def _ends_count(dims):
    """(ni+1, nj+1, nk+1) int field: how many of a node's indices lie on the
    block boundary (0=strict interior, 1=face, 2=edge, 3=corner)."""
    cnt = np.zeros(tuple(d + 1 for d in dims), dtype=np.int8)
    for a, d in enumerate(dims):
        sl = [slice(None)] * 3
        e = np.zeros(d + 1, dtype=np.int8)
        e[0] = e[-1] = 1
        sh = [1, 1, 1]
        sh[a] = d + 1
        cnt = cnt + e.reshape(sh)
    return cnt


def _window_sum8(slab, dims):
    """sum of the 8 cells surrounding each node; slab has one extra cell on
    each side of every grid dim: (..., ni+2, nj+2, nk+2) -> node sums
    (..., ni+1, nj+1, nk+1)."""
    ni, nj, nk = dims
    out = 0.0
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                out = out + slab[..., a:a + ni + 1, b:b + nj + 1,
                                 c:c + nk + 1]
    return out


def assign_corner_ghosts(padded, g):
    """First-layer 3-D corner ghost cells = mean of the three adjacent
    edge-ghost cells (reference: procBlock.cpp:2716 AssignCornerGhostCells
    — only used for cell-to-node interpolation)."""
    out = np.array(padded)
    ni = padded.shape[-3] - 2 * g
    nj = padded.shape[-2] - 2 * g
    nk = padded.shape[-1] - 2 * g
    third = 1.0 / 3.0
    for ig in (g - 1, g + ni):
        si = 1 if ig == g - 1 else -1
        for jg in (g - 1, g + nj):
            sj = 1 if jg == g - 1 else -1
            for kg in (g - 1, g + nk):
                sk = 1 if kg == g - 1 else -1
                out[..., ig, jg, kg] = third * (
                    out[..., ig + si, jg, kg] + out[..., ig, jg + sj, kg]
                    + out[..., ig, jg, kg + sk])
    return out


def cell_to_node_state(padded, g):
    """ConvertCellToNode, ghost path, ignoreEdge=False: every node is the
    mean of its 8 surrounding cells, boundary nodes using one ghost layer
    (incl. edge/corner ghosts) (reference: utility.hpp:192-273,330-332)."""
    dims = tuple(s - 2 * g for s in padded.shape[-3:])
    ni, nj, nk = dims
    slab = padded[..., g - 1:g + ni + 1, g - 1:g + nj + 1, g - 1:g + nk + 1]
    return _window_sum8(slab, dims) / 8.0


def cell_to_node_ghost_ignore_edge(padded, g):
    """ghost path with ignoreEdge=True (residual-like fields that carry
    ghosts, e.g. wallDistance): edge/corner ghost cells are excluded and
    nodes on block edges / corners renormalize by 1/6 / 1/4
    (reference: utility.hpp:225-270, 307-329)."""
    dims = tuple(s - 2 * g for s in padded.shape[-3:])
    ni, nj, nk = dims
    slab = np.array(
        padded[..., g - 1:g + ni + 1, g - 1:g + nj + 1, g - 1:g + nk + 1])
    gi = np.zeros(ni + 2, bool)
    gi[[0, -1]] = True
    gj = np.zeros(nj + 2, bool)
    gj[[0, -1]] = True
    gk = np.zeros(nk + 2, bool)
    gk[[0, -1]] = True
    nghost = (gi[:, None, None].astype(int) + gj[None, :, None]
              + gk[None, None, :])
    slab[..., nghost >= 2] = 0.0
    s = _window_sum8(slab, dims)
    cnt = _ends_count(dims)
    fac = np.where(cnt >= 3, 0.25, np.where(cnt == 2, 1.0 / 6.0, 0.125))
    return s * fac


def cell_to_node_noghost_ignore_edge(interior):
    """no-ghost path with ignoreEdge=True (residuals, dt): corner nodes
    keep the single cell value, edge nodes average their 2 cells, all other
    nodes multiply the available-cell sum by 1/8 — including boundary-face
    nodes with only 4 contributions, replicating the reference's weighting
    (reference: utility.hpp:274-329)."""
    dims = interior.shape[-3:]
    pads = [(0, 0)] * (interior.ndim - 3) + [(1, 1)] * 3
    slab = np.pad(interior, pads)
    s = _window_sum8(slab, dims)
    cnt = _ends_count(dims)
    fac = np.where(cnt >= 3, 1.0, np.where(cnt == 2, 0.5, 0.125))
    return s * fac


def face_grads_to_node(face_arrs, dims):
    """Scatter per-direction FACE values to nodes with the reference's
    gradient weights: interior 1/12, boundary face 1/8, edge 1/5, corner
    1/3 (reference: procBlock.cpp:6625-6847).  face_arrs: {d: array} whose
    last three axes are grid-ordered (i, j, k) with the face count
    (n_d + 1) along d's axis and physical cell counts transverse."""
    ni, nj, nk = dims
    node_shape = None
    out = None
    for d, arr in face_arrs.items():
        ax = {"i": 0, "j": 1, "k": 2}[d]
        if out is None:
            node_shape = arr.shape[:-3] + (ni + 1, nj + 1, nk + 1)
            out = np.zeros(node_shape, arr.dtype)
        taxes = [a for a in range(3) if a != ax]
        for b in (0, 1):
            for c in (0, 1):
                sl = [slice(None)] * 3
                sl[ax] = slice(0, dims[ax] + 1)
                sl[taxes[0]] = slice(b, b + dims[taxes[0]])
                sl[taxes[1]] = slice(c, c + dims[taxes[1]])
                out[(Ellipsis,) + tuple(sl)] += arr
    cnt = _ends_count(dims)
    fac = np.where(cnt >= 3, 1.0 / 3.0,
                   np.where(cnt == 2, 0.2, np.where(cnt == 1, 0.125,
                                                    1.0 / 12.0)))
    return out * fac


def write_nodes(path, grids, l_ref):
    """Node-coordinate Plot3D grid (the original grid, dimensionalized) —
    the mesh the nodal .fun files index (reference: output.cpp:106)."""
    with open(path, "wb") as f:
        _write_block_dims(f, [gr.shape[:3] for gr in grids])
        for gr in grids:
            for n in range(3):
                f.write(np.ascontiguousarray(
                    (gr[..., n] * l_ref).transpose(2, 1, 0),
                    dtype="<f8").tobytes())


def write_meta(path, sim_root, grid_name, iteration, var_names,
               time_accurate=False, dt=0.0, output_frequency=1,
               is_center=True):
    """ParaView .p3d meta file (reference: output.cpp:903-1005)."""
    fend = "_center" if is_center else ""
    entry = {
        "time": iteration,
        "xyz": f"{grid_name}{fend}.xyz",
        "function": f"{os.path.basename(sim_root)}_{iteration}{fend}.fun",
    }
    meta = {
        "auto-detect-format": True,
        "format": "binary",
        "language": "C",
        "filenames": [entry],
        "function-names": list(var_names),
    }
    with open(path, "w") as f:
        json.dump(meta, f, indent=1)
