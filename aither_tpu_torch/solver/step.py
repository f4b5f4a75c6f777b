"""One solver step's building blocks: ghost fill, connection swaps,
residual, time step, update and norms.

Port of ``aither_tpu/solver/step.py`` (``:31-436`` ghosts and swaps,
``:443-524`` inviscid residual, ``:556-695`` full residual, ``:698-746``
time step, the explicit Euler, RK4 and implicit updates and norms).  Arrays are padded equation-first blocks
``(neq, NI, NJ, NK)`` as in the JAX package.  The ghost fills return a
filled copy of their input; the connection swap updates in place.

Connection swaps are index maps built once on the host (the orientation
helpers of ``grid/connections.py`` run on numpy index arrays), so a swap on the device is
one gather and one scatter per connection side.  A rank of a multi-rank
run walks the same connections in the same order with its exchange plan
(``rank_exchange_plan``, ``RankExchange``): a side whose donor block is
another rank's arrives as that rank's packed slab, staged through host
memory (``swap_case`` picks the form).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..grid.connections import orient_to_first, orient_to_second
from ..grid.geometry import AX
from ..kernels import viscous_march
from ..physics import chemistry as chem_mod
from ..physics.models import Physics
from . import bc as bc_mod
from . import block_jac as bj
from . import state as st
from .flux import inviscid_flux
from .reconstruction import reconstruct_faces

RK4_ALPHA = (0.25, 1.0 / 3.0, 0.5, 1.0)  # low-storage RK4 (procBlock.cpp:941)

# ---------------------------------------------------------------------------
# ghost-state assignment


def _cell_indices(g, n, lower: bool, layer: int):
    """(gcell, icell, acell) padded indices per ghost layer
    (reference: procBlock.cpp:2470-2500)."""
    if lower:
        gcell = g - layer
        icell = min(g + layer - 1, g + n - 1)
        acell = g
    else:
        gcell = g + n + layer - 1
        icell = max(g + n - layer, g)
        acell = g + n - 1
    return gcell, icell, acell


def _plane(arr, axis, idx, patch):
    """index plane `idx` on `axis` (1-based spatial axis within an
    equation-first array), patch slices elsewhere."""
    out = [slice(None)] * arr.dim()
    out[axis] = idx
    taxes = [a for a in range(arr.dim() - 3, arr.dim()) if a != axis]
    out[taxes[0]] = slice(*patch[0])
    out[taxes[1]] = slice(*patch[1])
    return tuple(out)


def boundary_normal(geom, spec, g, n):
    """Outward unit normal on the boundary faces of a surface patch:
    (3, ...)."""
    normals = geom[f"n_{spec.direction}"]
    bnd = g if spec.lower else g + n
    nvec = normals[_plane(normals, 1 + spec.axis, bnd, spec.patch)]
    return -nvec if spec.lower else nvec


def _apply(prim, updates):
    """Write (index, value) pairs into a copy of prim, in order; every
    value was computed from the input before any write (the JAX package's
    merged-region semantics)."""
    out = prim.clone()
    for idx, val in updates:
        out[idx] = val
    return out


def apply_boundary_ghosts(phys: Physics, block, prim, viscous_pass=False,
                          cfg=None, wall_data=None, bc_aux=None,
                          cons_n=None):
    """Assign ghost states for all non-connection surfaces
    (reference: procBlock.cpp:2449-2563).  For the inviscid pass
    viscousWall degrades to slipWall; the viscous pass re-does viscousWall
    surfaces with the full wall model (interior = mirrored cell,
    wall distance and wall kinematic viscosity from the adjacent cell;
    a wall-law surface reads ``cfg`` and stores its layer-1 wall-law
    values in ``wall_data`` by ``id(spec)``).  With ``bc_aux`` (the
    previous iteration's dt, pressure and velocity gradients by block
    interior cell) and ``cons_n`` (time-n conserved interior) the
    nonreflecting inlets and pressure outlets take their LODI form;
    without them the reflecting one.  Every value reads physical cells
    only, so all writes are independent."""
    g = block.g
    dims = {"i": block.ni, "j": block.nj, "k": block.nk}
    updates = []
    for layer in range(1, g + 1):
        for spec in block.surfaces:
            if spec.bc_type in ("interblock", "periodic"):
                continue
            bct = spec.bc_type
            if bct == "viscousWall" and not viscous_pass:
                bct = "slipWall"
            if viscous_pass and spec.bc_type != "viscousWall":
                continue
            n = dims[spec.direction]
            ax = 1 + spec.axis
            gcell, icell, acell = _cell_indices(g, n, spec.lower, layer)
            norm = boundary_normal(block.geom, spec, g, n)
            kw = {}
            if bct == "viscousWall":
                src = icell
                adj = prim[_plane(prim, ax, acell, spec.patch)]
                wd = block.geom["wall_dist"]
                kw["wall_dist"] = wd[_plane(wd, ax - 1, acell, spec.patch)]
                rho_adj = st.rho(phys, adj)
                t_adj = phys.temperature(adj[phys.ie], adj[:phys.ns])
                kw["nu_w"] = (phys.viscosity(t_adj,
                                             st.mixture_fractions(phys, adj))
                              / rho_adj)
                if spec.data is not None and spec.data.wall_law:
                    kw["cfg"] = cfg
                    if layer == 1 and wall_data is not None:
                        # wall data stored at layer 1 only
                        # (reference: procBlock.cpp:6288-6291)
                        kw["wvars_out"] = wall_data[id(spec)] = {}
            else:
                src = icell if bct == "slipWall" else acell
                if (bct in ("inlet", "pressureOutlet")
                        and spec.data is not None
                        and spec.data.nonreflecting and bc_aux is not None):
                    kw = _lodi_data(phys, block, prim, spec, norm, acell,
                                    bc_aux, cons_n)
            interior = prim[_plane(prim, ax, src, spec.patch)]
            ghost = bc_mod.ghost_state(phys, bct, interior, norm, spec.data,
                                       layer, **kw)
            updates.append((_plane(prim, ax, gcell, spec.patch), ghost))
    return _apply(prim, updates)


def _lodi_data(phys: Physics, block, prim, spec, norm, acell, bc_aux,
               cons_n):
    """LODI data of a nonreflecting surface at its adjacent cells: the
    time-n state, the previous iteration's dt and gradients, and the
    patch's max and mean signed Mach vn / a, kept on the device as 0-d
    tensors (reference: procBlock.cpp:2504-2516, 6236-6262)."""
    g = block.g
    n = {"i": block.ni, "j": block.nj, "k": block.nk}[spec.direction]
    isl = [None, None, None]
    isl[spec.axis] = 0 if spec.lower else n - 1
    taxes = [a for a in range(3) if a != spec.axis]
    for a, (lo, hi) in zip(taxes, spec.patch):
        isl[a] = slice(lo - g, hi - g)
    isl = tuple(isl)
    adj = prim[_plane(prim, 1 + spec.axis, acell, spec.patch)]
    mach = (st.velocity(phys, adj) * norm).sum(dim=0) / st.sos(phys, adj)
    return dict(state_n=st.prim_from_cons(phys, cons_n[(slice(None),) + isl]),
                dt=bc_aux["dt"][isl], max_mach=mach.max(),
                avg_mach=mach.mean(),
                pgrad=bc_aux["pgrad"][(slice(None),) + isl],
                vgrad=bc_aux["vgrad"][(slice(None), slice(None)) + isl])


# direction-2/3 pairs for the edge pass (procBlock edge convention:
# i-line -> d2=j, d3=k; j-line -> d2=k, d3=i; k-line -> d2=i, d3=j)
EDGE_DIRS = {"i": ("j", "k"), "j": ("k", "i"), "k": ("i", "j")}


def _surface_bc_types(block, d: str, lower: bool):
    """host-side map of bc type over a block face: object array (n1, n2) in
    the face's transverse axes order."""
    dims = {"i": block.ni, "j": block.nj, "k": block.nk}
    taxes = [a for a in "ijk" if a != d]
    types = np.empty((dims[taxes[0]], dims[taxes[1]]), dtype=object)
    types[:] = "none"
    for spec in block.surfaces:
        if spec.direction != d or spec.lower != lower:
            continue
        sl = tuple(slice(lo - block.g, hi - block.g) for lo, hi in spec.patch)
        types[sl] = spec.bc_type
    return types


def _wall_mask(block, dface: str, lower: bool, dline: str, upper_other: bool,
               wall_types):
    """Boolean mask over the edge line (device tensor, cached on the block):
    True where the bounding surface in `dface` direction is a wall at the
    corner position."""
    key = ("wall_mask", dface, lower, dline, upper_other, wall_types)
    if key not in block.cache:
        types = _surface_bc_types(block, dface, lower)
        taxes = [a for a in "ijk" if a != dface]
        li = taxes.index(dline)
        oi = 1 - li
        oidx = types.shape[oi] - 1 if upper_other else 0
        line_vals = np.take(types, oidx, axis=oi)
        mask = np.isin(line_vals.astype(str), wall_types)
        block.cache[key] = torch.as_tensor(
            mask, device=block.geom["vol"].device)
    return block.cache[key]


def _edge_face_normal(block, d, d2, d3, upper2, upper3, other_idx, which):
    """Outward unit normal of the wall face bounding an edge corner, along
    the edge line (3, n1)."""
    g = block.g
    dims = {"i": block.ni, "j": block.nj, "k": block.nk}
    if which == 2:
        dface, upper, dother = d2, upper2, d3
    else:
        dface, upper, dother = d3, upper3, d2
    normals = block.geom[f"n_{dface}"]
    fidx = g + dims[dface] if upper else g
    out = [slice(None)] * 4
    out[1 + AX[dface]] = fidx
    out[1 + AX[d]] = slice(g, g + dims[d])
    out[1 + AX[dother]] = other_idx
    nvec = normals[tuple(out)]
    return nvec if upper else -nvec


def apply_edge_ghosts(phys: Physics, block, prim, viscous_pass=False):
    """Corner/edge ghost states (reference: procBlock.cpp:2565-2804 inviscid,
    :2806-3049 viscous): wall surfaces extend their reflection into the
    corner; otherwise equal layers average and unequal layers copy from the
    deeper direction.  The viscous pass treats only viscousWall corners.

    One write per (layer3, layer2) pair: within a pair the 3 edge
    directions x 4 corners write disjoint cells and read only cells of
    earlier pairs or the surface pass (the JAX package's pair order)."""
    g = block.g
    dims = {"i": block.ni, "j": block.nj, "k": block.nk}
    for layer3 in range(1, g + 1):
        for layer2 in range(1, g + 1):
            updates = []
            for d in "ijk":
                d2, d3 = EDGE_DIRS[d]
                ax1, ax2, ax3 = 1 + AX[d], 1 + AX[d2], 1 + AX[d3]
                max2, max3 = dims[d2], dims[d3]
                line = slice(g, g + dims[d])
                for upper2 in (False, True):
                    for upper3 in (False, True):
                        if upper2:
                            p2 = g + max2 + layer2 - 2
                            c2 = p2 + 1
                        else:
                            p2 = g + 1 - layer2
                            c2 = p2 - 1
                        if upper3:
                            p3 = g + max3 + layer3 - 2
                            c3 = p3 + 1
                        else:
                            p3 = g + 1 - layer3
                            c3 = p3 - 1

                        def sl(i2, i3):
                            out = [slice(None)] * prim.dim()
                            out[ax1] = line
                            out[ax2] = i2
                            out[ax3] = i3
                            return tuple(out)

                        s_d2 = prim[sl(p2, c3)]   # toward direction 2
                        s_d3 = prim[sl(c2, p3)]   # toward direction 3
                        norm2 = _edge_face_normal(block, d, d2, d3, upper2,
                                                  upper3, c3, which=2)
                        norm3 = _edge_face_normal(block, d, d2, d3, upper2,
                                                  upper3, c2, which=3)
                        ghost_w2 = bc_mod.slip_wall(phys, s_d2, norm2,
                                                    None, layer2)
                        ghost_w3 = bc_mod.slip_wall(phys, s_d3, norm3,
                                                    None, layer3)
                        if layer2 == layer3:
                            normal = 0.5 * (s_d2 + s_d3)
                        elif layer2 > layer3:
                            normal = s_d3
                        else:
                            normal = s_d2

                        if viscous_pass:
                            # a slipWall surface extends its reflection over
                            # a mixed corner; viscousWall/viscousWall
                            # corners use the average/copy rules; others
                            # are untouched (procBlock.cpp:2925-2960)
                            s2 = _wall_mask(block, d2, not upper2, d, upper3,
                                            ("slipWall",))
                            s3 = _wall_mask(block, d3, not upper3, d, upper2,
                                            ("slipWall",))
                            v2 = _wall_mask(block, d2, not upper2, d, upper3,
                                            ("viscousWall",))
                            v3 = _wall_mask(block, d3, not upper3, d, upper2,
                                            ("viscousWall",))
                            ghost = torch.where(
                                (s2 & ~s3)[None], ghost_w2,
                                torch.where((~s2 & s3)[None], ghost_w3,
                                            torch.where((v2 & v3)[None],
                                                        normal,
                                                        prim[sl(c2, c3)])))
                        else:
                            # inviscid pass: slipWall OR viscousWall counts
                            # as a wall (procBlock.cpp:2674-2710)
                            walls = ("slipWall", "viscousWall")
                            w2 = _wall_mask(block, d2, not upper2, d, upper3,
                                            walls)
                            w3 = _wall_mask(block, d3, not upper3, d, upper2,
                                            walls)
                            ghost = torch.where(
                                (w2 & ~w3)[None], ghost_w2,
                                torch.where((~w2 & w3)[None], ghost_w3,
                                            normal))
                        updates.append((sl(c2, c3), ghost))
            prim = _apply(prim, updates)
    return prim


# ---------------------------------------------------------------------------
# interblock / periodic connection swaps as host-built index maps


def connection_index_maps(blocks, conns, g, device):
    """For each connection, its two sides as (acceptor block, acceptor flat
    indices, donor block, donor flat indices), indices into a block's
    flattened padded (NI*NJ*NK) cells.

    Built by running the JAX package's ``swap_all_connection_states``
    slab logic (reference: multiArray3d.hpp:790-870 SwapSliceLocal) on
    numpy index arrays: the ghost slab of the acceptor, extended by g in
    the patch directions except where the patch borders another
    connection, takes the donor's first g interior layers, reoriented."""
    out = []
    for conn in conns:
        sides = []
        for acceptor, donor, to_first, border in (
                (conn.first, conn.second, True, conn.border_first),
                (conn.second, conn.first, False, conn.border_second)):
            blk_a = blocks[acceptor.block]
            blk_d = blocks[donor.block]
            n_a = {"i": blk_a.ni, "j": blk_a.nj,
                   "k": blk_a.nk}[acceptor.direction]
            n_d = {"i": blk_d.ni, "j": blk_d.nj,
                   "k": blk_d.nk}[donor.direction]
            ea = [0 if border[idx] else g for idx in range(4)]
            a1 = slice(g + acceptor.d1_range[0] - ea[0],
                       g + acceptor.d1_range[1] + ea[1])
            a2 = slice(g + acceptor.d2_range[0] - ea[2],
                       g + acceptor.d2_range[1] + ea[3])
            d1 = slice(donor.d1_range[0], g + donor.d1_range[1] + g)
            d2 = slice(donor.d2_range[0], g + donor.d2_range[1] + g)
            ids_d = np.arange(np.prod(blk_d.shape)).reshape(blk_d.shape)
            ids_a = np.arange(np.prod(blk_a.shape)).reshape(blk_a.shape)
            rem_d = [a for a in range(3) if a != AX[donor.direction]]
            rem_a = [a for a in range(3) if a != AX[acceptor.direction]]
            full1 = acceptor.d1_range[1] - acceptor.d1_range[0] + 2 * g
            lo1, hi1 = g - ea[0], full1 - (g - ea[1])
            full2 = acceptor.d2_range[1] - acceptor.d2_range[0] + 2 * g
            lo2, hi2 = g - ea[2], full2 - (g - ea[3])
            orient = orient_to_first if to_first else orient_to_second
            acc_idx, don_idx = [], []
            for layer in range(1, g + 1):
                didx = g + layer - 1 if donor.lower else g + n_d - layer
                idx = [None] * 3
                idx[AX[donor.direction]] = didx
                idx[AX[donor.d1]] = d1
                idx[AX[donor.d2]] = d2
                plane = ids_d[tuple(idx)]
                if rem_d.index(AX[donor.d1]) != 0:
                    plane = np.swapaxes(plane, 0, 1)
                plane = orient(plane, conn.orientation, 0, 1,
                               conn.second.direction)[lo1:hi1, lo2:hi2]
                if rem_a.index(AX[acceptor.d1]) != 0:
                    plane = np.swapaxes(plane, 0, 1)
                gidx = g - layer if acceptor.lower else g + n_a + layer - 1
                idx = [None] * 3
                idx[AX[acceptor.direction]] = gidx
                idx[AX[acceptor.d1]] = a1
                idx[AX[acceptor.d2]] = a2
                region = ids_a[tuple(idx)]
                assert region.shape == plane.shape, (region.shape,
                                                     plane.shape)
                acc_idx.append(region.ravel())
                don_idx.append(plane.ravel())
            sides.append((acceptor.block,
                          torch.as_tensor(np.concatenate(acc_idx),
                                          device=device),
                          donor.block,
                          torch.as_tensor(np.concatenate(don_idx),
                                          device=device)))
        out.append(sides)
    return out


def swap_connections(fields: dict, maps) -> dict:
    """Ghost-slab swaps of padded (C, NI, NJ, NK) fields across every
    connection, IN PLACE, one connection at a time.  The order matters
    where connections meet: a connection's acceptor slab is extended by g
    along the patch except where the patch borders another connection, so
    a later connection's donor slab reads ghost corners that an earlier
    one wrote (the four connections of the plate at ``--nproc 4``), exactly
    as the reference's sequential SwapSlice loop (gridLevel.cpp:299-313).
    Batching every connection at once gives other corner ghosts.  Within
    one connection both sides gather before either scatters.  A multi-rank
    run walks the same order (``RankExchange``).  Returns ``fields``."""
    for sides in maps:
        vals = [fields[don_b].reshape(fields[don_b].shape[0], -1)[:, don_idx]
                for _, _, don_b, don_idx in sides]
        for (acc_b, acc_idx, _, _), v in zip(sides, vals):
            dst = fields[acc_b]
            dst.view(dst.shape[0], -1)[:, acc_idx] = v
    return fields


@dataclasses.dataclass
class ExchangeStep:
    """One connection as one rank sees it.  ``local``: the sides whose
    acceptor and donor blocks are both this rank's, as in
    ``connection_index_maps``; ``peer``: the rank owning the connection's
    other block when that is not this rank (else -1), with ``send`` (donor
    block, flat indices: this rank's slab of the peer's ghosts) and
    ``recv`` (acceptor block, flat indices: this rank's ghosts from the
    peer's slab)."""

    conn: int
    local: list
    peer: int = -1
    send: tuple = None
    recv: tuple = None


def rank_exchange_plan(maps, owners, rank, device) -> list:
    """The ``ExchangeStep`` of every connection that touches a block of
    ``rank``, in the global connection order (``maps`` from
    ``connection_index_maps``, ``owners[block]`` the owning rank), its
    indices on ``device``.  A connection joins at most two blocks, so a
    remote one has one send and one receive, both with the same peer."""
    steps = []
    for c, sides in enumerate(maps):
        local, send, recv, peer = [], None, None, -1
        for acc_b, acc_idx, don_b, don_idx in sides:
            mine_a, mine_d = owners[acc_b] == rank, owners[don_b] == rank
            if mine_a and mine_d:
                local.append((acc_b, acc_idx.to(device), don_b,
                              don_idx.to(device)))
            elif mine_a:
                recv, peer = (acc_b, acc_idx.to(device)), owners[don_b]
            elif mine_d:
                send, peer = (don_b, don_idx.to(device)), owners[acc_b]
        if local or peer >= 0:
            if peer >= 0 and (send is None or recv is None):
                raise ValueError(f"connection {c}: one side remote only")
            steps.append(ExchangeStep(c, local, peer, send, recv))
    return steps


class RankExchange:
    """The connection swaps of one rank's blocks (``swap``, in place, as
    ``swap_connections`` on the whole case): every rank walks the
    connections in the global order; a connection with both blocks local
    is the gather and scatter of ``swap_connections``; one with a remote
    side packs this rank's donor slab into one contiguous buffer, stages it
    through host memory, and ``transport.sendrecv(peer, host_slab,
    recv_shape)`` returns the peer's slab (host) for this rank's ghosts,
    before the next connection.  ``transport`` is the rank's communicator
    (``parallel/distributed.Comm``) or, in a test, a stand-in.

    ``bytes`` counts the bytes sent and received, ``seconds`` the host time
    inside ``swap`` (with ``timed`` the device is synchronised on entry, so
    that it is the exchange's own time: packing, staging, the peer's
    wait and the scatter), ``calls`` the swaps."""

    def __init__(self, steps, transport):
        self.steps = steps
        self.transport = transport
        self.timed = False
        self.bytes = 0
        self.seconds = 0.0
        self.calls = 0

    def swap(self, fields: dict) -> dict:
        if self.timed and fields:
            dev = next(iter(fields.values())).device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for step in self.steps:
            vals = [fields[don_b].reshape(fields[don_b].shape[0], -1)[
                :, don_idx] for _, _, don_b, don_idx in step.local]
            got = None
            if step.peer >= 0:
                don_b, don_idx = step.send
                src = fields[don_b]
                slab = src.reshape(src.shape[0], -1)[:, don_idx].cpu()
                acc_b, acc_idx = step.recv
                got = self.transport.sendrecv(
                    step.peer, slab, (src.shape[0], acc_idx.numel()))
                self.bytes += (slab.numel() + got.numel()) * slab.element_size()
            for (acc_b, acc_idx, _, _), v in zip(step.local, vals):
                dst = fields[acc_b]
                dst.view(dst.shape[0], -1)[:, acc_idx] = v
            if got is not None:
                acc_b, acc_idx = step.recv
                dst = fields[acc_b]
                dst.view(dst.shape[0], -1)[:, acc_idx] = got.to(dst.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return fields


def swap_case(case, fields: dict) -> dict:
    """``swap_connections`` of ``case``'s connections on its blocks: the
    rank's exchange in a multi-rank run (``case.exchange``)."""
    if case.exchange is not None:
        return case.exchange.swap(fields)
    return swap_connections(fields, case.swap_maps)


def apply_all_bcs(phys: Physics, case, prims, bc_aux=None, cons_n=None):
    """Full ghost update: boundary surfaces, connection swaps, edges
    (reference ordering: procBlock::GetBoundaryConditions ->
    gridLevel.cpp:287-370).  bc_aux / cons_n ({block: ...}) feed the
    nonreflecting (LODI) BCs with the previous iteration's dt and
    gradients and the time-n state."""
    prims = {b.index: apply_boundary_ghosts(
        phys, b, prims[b.index],
        bc_aux=None if bc_aux is None else bc_aux.get(b.index),
        cons_n=None if cons_n is None else cons_n.get(b.index))
        for b in case.blocks}
    swap_case(case, prims)
    return {b.index: apply_edge_ghosts(phys, b, prims[b.index])
            for b in case.blocks}


# ---------------------------------------------------------------------------
# residual + spectral radius


def inviscid_residual(phys: Physics, cfg, block, prim):
    """Net inviscid outflux per physical cell + inviscid spectral radii
    (flow & turbulence) (reference: procBlock.cpp:384-824).  Returns
    (resid, specrad, specrad_turb); with ``cfg['block_matrix']`` (blusgs)
    also the inviscid block diagonals diag_flow_blk (ni, nj, nk, N, N) and
    diag_turb_blk (ni, nj, nk, 2, 2), accumulated from the Rusanov block
    Jacobians at the reconstructed face states."""
    g = block.g
    geom = block.geom
    dims = dict(i=block.ni, j=block.nj, k=block.nk)
    kw = dict(dtype=prim.dtype, device=prim.device)
    shape_c = (block.ni, block.nj, block.nk)
    resid = torch.zeros((phys.neq,) + shape_c, **kw)
    specrad = torch.zeros(shape_c, **kw)
    specrad_turb = torch.zeros(shape_c, **kw)
    blk = bool(cfg.get("block_matrix"))
    if blk:
        N = phys.ns + 4
        diag_flow_blk = torch.zeros(shape_c + (N, N), **kw)
        diag_turb_blk = (torch.zeros(shape_c + (2, 2), **kw) if phys.nturb
                         else None)
    P = [slice(g, g + dims[d]) for d in "ijk"]
    cell = prim[tuple([slice(None)] + P)]
    vel = st.velocity(phys, cell)
    a = st.sos(phys, cell)

    for d in "ijk":
        ax = 1 + AX[d]
        n = dims[d]
        # restrict transverse extents to physical cells; keep ghosts along d
        tsl = [slice(None)] * 4
        for aa, dd in enumerate("ijk"):
            if dd != d:
                tsl[1 + aa] = slice(g, g + dims[dd])
        prim_d = prim[tuple(tsl)]
        widths = geom[f"width_{d}"][tuple(tsl[1:])]
        ql, qr = reconstruct_faces(prim_d, widths, ax, g, n, cfg["recon"],
                                   cfg["kappa"], cfg["limiter"])
        fidx = [slice(None)] * 4
        for aa, dd in enumerate("ijk"):
            fidx[1 + aa] = slice(g, g + dims[dd] + (1 if dd == d else 0))
        nvec = geom[f"n_{d}"][tuple(fidx)]
        mag = geom[f"mag_{d}"][tuple(fidx[1:])]
        flux = inviscid_flux(phys, ql, qr, nvec, cfg["flux"]) * mag[None]

        lo = [slice(None)] * 4
        hi = [slice(None)] * 4
        lo[ax] = slice(0, n)
        hi[ax] = slice(1, n + 1)
        resid = resid + flux[tuple(hi)] - flux[tuple(lo)]

        if blk:
            # block-diagonal accumulation at the reconstructed face states
            # (reference: procBlock.cpp:450-495)
            jf_pos, jt_pos = bj.rusanov_flux_jacobian(phys, ql, nvec, mag,
                                                      True)
            jf_neg, jt_neg = bj.rusanov_flux_jacobian(phys, qr, nvec, mag,
                                                      False)
            flo3, fhi3 = tuple(lo[1:]), tuple(hi[1:])
            diag_flow_blk = diag_flow_blk + jf_pos[fhi3] - jf_neg[flo3]
            if phys.nturb:
                diag_turb_blk = diag_turb_blk + jt_pos[fhi3] - jt_neg[flo3]

        # inviscid cell spectral radius (spectralRadius.hpp:43-64)
        nl = nvec[tuple(lo)]
        nh = nvec[tuple(hi)]
        navg = 0.5 * (nl + nh)
        navg = navg / torch.sqrt((navg * navg).sum(dim=0))[None]
        fmag = 0.5 * (mag[tuple(lo[1:])] + mag[tuple(hi[1:])])
        vn = torch.abs((vel * navg).sum(dim=0))
        specrad = specrad + (vn + a) * fmag
        if phys.nturb:
            # turbulence inviscid spectral radius (turbulence.cpp:100-110)
            specrad_turb = specrad_turb + vn * fmag
    if blk:
        return resid, specrad, specrad_turb, diag_flow_blk, diag_turb_blk
    return resid, specrad, specrad_turb


def full_residual(phys: Physics, cfg, block, prim, need_aux=False):
    """Residual + spectral radii + diagonal terms for one block: inviscid
    fluxes, viscous fluxes, turbulence sources (reference:
    procBlock.cpp:6111-6147 CalcResidualNoSource + :5956 CalcSrcTerms).

    ``need_aux=False`` is the per-iteration form: the output-only gradient
    fields are not accumulated.  ``need_aux=True`` is the file output's
    (``Solver.write_output``): the plain viscous residual with the
    cell-average temperature, density, pressure and mass-fraction
    gradients and the wall records ``cellavg['wall_out']``
    (``viscous.viscous_residual``).  Returns
    (resid, sr_flow, sr_turb, diag_flow, diag_turb, cellavg, prim, aux)
    where prim carries the viscous-wall ghosts and aux the padded mu, mut
    and f1 the implicit off-diagonals read (mut and f1 are zeros for a
    laminar deck; an inviscid deck has cellavg None and, for the scalar
    solver, aux None).  With ``cfg['block_matrix']`` (blusgs) aux also
    holds the block diagonals 'diag_flow_blk' (ni, nj, nk, N, N) and
    'diag_turb_blk' (ni, nj, nk, 2, 2; None without turbulence equations)
    — inviscid Rusanov, viscous TSL and the turbulence source Jacobian —
    and, when viscous, the padded cell-average velocity gradient 'vgrad'
    (3, 3, NI, NJ, NK) of the TSL off-diagonals.  A viscous deck with
    nonreflecting (LODI) surfaces (``cfg['need_pgrad']``) also gets the
    cell-average pressure gradient 'press_grad' (3, ni, nj, nk) in aux,
    which Solver._iteration carries to the next iteration's boundary pass."""
    from . import viscous as vis

    blk = bool(cfg.get("block_matrix"))
    if blk:
        (resid, sr_flow, sr_turb, diag_flow_blk,
         diag_turb_blk) = inviscid_residual(phys, cfg, block, prim)
    else:
        resid, sr_flow, sr_turb = inviscid_residual(phys, cfg, block, prim)
    diag_flow = sr_flow
    diag_turb = sr_turb
    cellavg = None
    aux = None
    g = block.g
    P = tuple(slice(g, g + n) for n in (block.ni, block.nj, block.nk))

    if cfg.get("viscous"):
        # viscousWall ghosts (a wall-law surface stores its wall-law
        # values in wall_data), then the aux fields once on the filled
        # state
        wall_data = {}
        prim = apply_boundary_ghosts(phys, block, prim, viscous_pass=True,
                                     cfg=cfg, wall_data=wall_data)
        prim = apply_edge_ghosts(phys, block, prim, viscous_pass=True)
        t_all = phys.temperature(prim[phys.ie], prim[:phys.ns])
        mu_all = phys.viscosity(t_all, st.mixture_fractions(phys, prim))
        plain = dict(wall_data=wall_data,
                     need_pgrad=bool(cfg.get("need_pgrad")),
                     need_aux=need_aux)
        if blk:
            # blusgs takes the plain viscous residual, which also returns
            # the TSL block diagonal: the JAX package routes block-matrix
            # solvers around its fused march the same way
            # (pallas_residual.use_march), so K2 is not on this path there
            # either — not a fallback
            (rv, vsr_f, vsr_t, vdiag_f, vdiag_t, cellavg, vblk_f,
             vblk_t) = vis.viscous_residual(phys, cfg, block, prim, t_all,
                                            mu_all, **plain)
            diag_flow_blk = diag_flow_blk + vblk_f
            if phys.nturb:
                diag_turb_blk = diag_turb_blk + vblk_t
        elif phys.ns > 1:
            # a mixture takes the plain viscous residual: the JAX package's
            # fused march covers one species only (pallas_residual.py:112,
            # use_march), so K2 is not on this path there either — the
            # JAX package's route, not a fallback
            (rv, vsr_f, vsr_t, vdiag_f, vdiag_t,
             cellavg) = vis.viscous_residual(phys, cfg, block, prim, t_all,
                                             mu_all, **plain)
        elif need_aux:
            # the output evaluation takes the plain viscous residual,
            # which forms the output fields: the JAX package's
            # full_residual picks its fused march only without need_aux
            # (aither_tpu/solver/step.py:590) — its route, not a fallback
            (rv, vsr_f, vsr_t, vdiag_f, vdiag_t,
             cellavg) = vis.viscous_residual(phys, cfg, block, prim, t_all,
                                             mu_all, **plain)
        elif (cfg.get("viscous_recon", "central") == "centralFourth"
              or phys.thermally_perfect):
            # a centralFourth deck reconstructs its face states from four
            # cells, and a thermally perfect gas takes its cp and gamma as
            # functions of T, neither of which the fused march does: the
            # JAX package's use_march sends both to the plain viscous
            # residual (pallas_residual.py:116-119) — its route, not a
            # fallback
            (rv, vsr_f, vsr_t, vdiag_f, vdiag_t,
             cellavg) = vis.viscous_residual(phys, cfg, block, prim, t_all,
                                             mu_all, **plain)
        elif cfg.get("need_pgrad") or vis.has_wall_law(block):
            # a deck with LODI (nonreflecting) surfaces needs the cell
            # pressure gradient, which the fused march does not form, and
            # a block with a wall-law surface needs the wall-law face
            # values, which it does not apply: the JAX package's
            # use_march sends both to the plain viscous residual
            # (pallas_residual.py:114-115, 120-123) — its route, not a
            # fallback
            (rv, vsr_f, vsr_t, vdiag_f, vdiag_t,
             cellavg) = vis.viscous_residual(phys, cfg, block, prim, t_all,
                                             mu_all, **plain)
        else:
            # the fused viscous residual: the CUDA kernel on the card, its
            # plain version on the CPU
            (rv, vsr_f, vsr_t, vdiag_f, vdiag_t,
             cellavg) = viscous_march.viscous_residual(phys, cfg, block,
                                                       prim, t_all, mu_all)
        resid = resid + rv
        sr_flow = sr_flow + vsr_f
        sr_turb = sr_turb + vsr_t
        diag_flow = diag_flow + vdiag_f
        diag_turb = diag_turb + vdiag_t

        # padded aux arrays for implicit off-diagonal Jacobians
        mut_pad = torch.zeros_like(mu_all)
        mut_pad[P] = cellavg["mut"]
        f1_pad = torch.zeros_like(mu_all)
        f1_pad[P] = cellavg["f1"]
        aux = {"mu": mu_all, "mut": mut_pad, "f1": f1_pad,
               "vel_grad": cellavg["vel"], "cellavg": cellavg}
        if "press" in cellavg:
            aux["press_grad"] = cellavg["press"]

    if phys.chemistry is not None:
        # reacting chemistry source terms (reference: procBlock.cpp:
        # 5956-6000, source.cpp:44-57, chemistry.cpp:81-176)
        cell_q = prim[(slice(None),) + P]
        vol = block.geom["vol"][P]
        t_cell = st.temperature(phys, cell_q)
        src, srad = chem_mod.source_terms(phys, phys.chemistry,
                                          cell_q[:phys.ns], t_cell)
        # residual -= src * vol (source on the RHS)
        resid = torch.cat([resid[:phys.ns] + (-src * vol[None]),
                           resid[phys.ns:]])
        # spectral radius / diagonal: subtract the (negative) destruction
        sr_flow = sr_flow - srad * vol
        diag_flow = diag_flow - srad * vol
        if blk:
            cjac = chem_mod.source_jacobian(phys, phys.chemistry,
                                            cell_q[:phys.ns], t_cell, src)
            diag_flow_blk = diag_flow_blk - cjac * vol[..., None, None]

    if phys.nturb and cfg.get("viscous"):
        cell_q = prim[(slice(None),) + P]
        vol = block.geom["vol"][P]
        width = torch.maximum(torch.maximum(block.geom["width_i"][P],
                                            block.geom["width_j"][P]),
                              block.geom["width_k"][P])
        src_k, src_w, src_rad = vis.turb_source(
            phys, cfg["turb_model"], cell_q, cellavg["vel"], cellavg["tke"],
            cellavg["omega"], cellavg["mut"], cellavg["f1"], cellavg["f2"],
            width)
        # residual -= src * vol (sources on the RHS; procBlock.cpp:6020)
        resid = torch.cat([resid[:phys.it],
                           (resid[phys.it] + (-src_k * vol))[None],
                           (resid[phys.it + 1] + (-src_w * vol))[None],
                           resid[phys.it + 2:]])
        # spectral radius / diagonal: subtract (negative) source jacobian
        sr_turb = sr_turb - src_rad * vol
        diag_turb = diag_turb - src_rad * vol
        if blk:
            model = cfg["turb_model"]
            f1c = cellavg["f1"]
            if model == "kOmegaWilcox2006":
                # the TurbSrcJac form with the same beta as CalcTurbSrc
                beta = vis.wilcox_beta(phys, cell_q, cellavg["vel"])
            else:
                beta = (f1c * vis.SST["beta1"]
                        + (1.0 - f1c) * vis.SST["beta2"])
            phi_des = 1.0
            if model == "sstdes":
                cdes = (f1c * vis.DES["cdes1"]
                        + (1.0 - f1c) * vis.DES["cdes2"])
                tls = torch.sqrt(cell_q[phys.it]) / (
                    vis.SST["beta_star"] * cell_q[phys.it + 1]) \
                    * phys.nondim_scaling
                phi_des = torch.clamp(
                    (1.0 - cellavg["f2"]) * tls / (cdes * width), min=1.0)
            diag_turb_blk = diag_turb_blk - bj.turb_src_jacobian(
                phys, cfg, cell_q, vol, beta, phi_des)

    if blk:
        aux = aux or {}
        aux["diag_flow_blk"] = diag_flow_blk
        aux["diag_turb_blk"] = diag_turb_blk
        if cellavg is not None:
            vgrad = torch.zeros((3, 3) + prim.shape[1:], dtype=prim.dtype,
                                device=prim.device)
            vgrad[(slice(None), slice(None)) + P] = cellavg["vel"]
            aux["vgrad"] = vgrad

    return resid, sr_flow, sr_turb, diag_flow, diag_turb, cellavg, prim, aux


def local_dt(cfg, geom, specrad, g, dims, cfl):
    """Local or global time step (reference: procBlock.cpp:6397-6420
    CalcBlockTimeStep/CalcCellDt)."""
    P = tuple(slice(g, g + n) for n in dims)
    vol = geom["vol"][P]
    if cfg["dt"] > 0.0:
        return torch.full_like(vol, cfg["dt_nondim"])
    return cfl * vol / specrad


def explicit_euler_update(phys: Physics, block, prim, resid, dt):
    """cons - dt/V R on the interior, back to primitives; returns a new
    padded array (reference: procBlock.cpp:866-899)"""
    vol = block.geom["vol"][block.interior[1:]]
    cons = st.cons_from_prim(phys, prim[block.interior])
    out = prim.clone()
    out[block.interior] = st.prim_from_cons(
        phys, cons - (dt / vol)[None] * resid)
    return out


def rk4_update(phys: Physics, block, prim, cons_n, resid, dt, stage):
    """low-storage RK4 stage ``stage``: consN - alpha dt/V R on the
    interior, back to primitives; returns a new padded array (reference:
    procBlock.cpp:927-950)"""
    vol = block.geom["vol"][block.interior[1:]]
    out = prim.clone()
    out[block.interior] = st.prim_from_cons(
        phys, cons_n - (dt / vol)[None] * RK4_ALPHA[stage] * resid)
    return out


def implicit_update(phys: Physics, block, prim, du):
    """(reference: procBlock.cpp:902-925)"""
    out = prim.clone()
    out[block.interior] = st.update_prim_with_cons(
        phys, prim[block.interior], du)
    return out


def residual_norms(resid):
    """per-equation sum of squares + (max value, flat location)
    (reference: procBlock.cpp:826-864 UpdateBlock accumulation)."""
    l2 = (resid * resid).sum(dim=(1, 2, 3))
    flat = resid.reshape(-1)
    return l2, flat.max(), torch.argmax(flat)
