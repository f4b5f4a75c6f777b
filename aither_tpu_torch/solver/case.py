"""Case construction: deck + grid -> per-block solver context on a device.

Port of ``aither_tpu/solver/case.py:347-465``.  The deck parser, Plot3D
reader, geometry, ghost nodes, connections and decomposition are the
port's own copies of the JAX package's host layers (``io/``, ``grid/``,
``parallel/``, ``physics/fluid.py``).  What differs:

* the initial state is computed with plain floats (no jax device); a
  point-cloud one (``icState(file=...)``) takes each cell's nearest cloud
  point by the copied k-d tree (``io/cloud.py``, ``utils/native.py``),
  on the host as there,
* the wall distance is an exact chunked brute-force nearest viscous-face
  search in torch on the case's device; the ghost layers mirror it by the
  JAX package's host rules (``case.py:277-344``) and the connection ghosts
  take it through the same index maps as the state swap,
* geometry is returned as torch tensors on the device, with a numpy mirror
  (``geom_host``) for host consumers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from ..grid import connections as conn_mod
from ..grid.geometry import (AX, BlockGeometry, build_block_geometry,
                             finalize_block_geometry)
from ..grid.ghost_nodes import fill_interblock_geometry
from ..io.deck import Deck, parse_deck
from ..io.plot3d import read_p3d
from ..physics.models import Physics
from .bc import BCData, make_bc_data
from .step import connection_index_maps, swap_connections

# size of one chunk's (cells x wall faces) distance matrix in the
# wall-distance search
WALL_DIST_CHUNK_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class SurfaceSpec:
    """Static description of one boundary surface on a padded block."""

    bc_type: str
    direction: str            # i/j/k
    lower: bool
    tag: int
    # padded cell ranges in the two transverse axes, ordered by axis number
    patch: tuple              # ((lo, hi), (lo, hi))
    data: Any = None          # BCData or None

    @property
    def axis(self):
        return AX[self.direction]


@dataclasses.dataclass
class Block:
    """One block's solver context."""

    index: int
    parent: int               # parent block in the original grid
    ni: int
    nj: int
    nk: int
    g: int
    geom: dict                # torch tensors on the case's device
    surfaces: list            # list[SurfaceSpec]
    prim0: Any                # initial padded primitive tensor (device)
    geom_host: dict = None    # numpy mirror of geom
    # per-block host-built constants (masks, index maps), filled lazily
    cache: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self):
        return (self.ni + 2 * self.g, self.nj + 2 * self.g,
                self.nk + 2 * self.g)

    @property
    def interior(self):
        """index tuple of the physical cells of a (neq, NI, NJ, NK) array"""
        g = self.g
        return (slice(None), slice(g, g + self.ni), slice(g, g + self.nj),
                slice(g, g + self.nk))


@dataclasses.dataclass
class Case:
    deck: Deck
    phys: Physics
    blocks: list
    connections: list
    total_cells: float
    dtype: Any
    device: Any
    swap_maps: list = None    # step.connection_index_maps
    # node arrays and BCs of the blocks (after decomposition), from which
    # multigrid builds the coarse levels (solver/multigrid.py)
    grids: list = None
    bcs: list = None
    # the grid's decomposition (parallel.decompose.Decomposition) of an
    # nproc > 1 case, else None; file output recombines by it
    decomp: Any = None


def _surface_specs(deck: Deck, bc, g: int) -> list:
    specs = []
    for s in bc.surfaces:
        rng = s.ranges()
        ax = AX[s.direction]
        patch = tuple((g + lo, g + hi) for a, (lo, hi) in enumerate(rng)
                      if a != ax)
        data = None
        if s.bc_type not in ("interblock", "periodic", "slipWall"):
            try:
                data = make_bc_data(deck.bc_data(s.tag), deck)
            except KeyError:
                data = BCData()
        specs.append(SurfaceSpec(bc_type=s.bc_type, direction=s.direction,
                                 lower=s.is_lower, tag=s.tag, patch=patch,
                                 data=data))
    return specs


def initial_prim(deck: Deck, phys: Physics, block_idx: int,
                 shape, centers=None, workdir=None) -> np.ndarray:
    """Nondimensional initial condition (reference: primitive.cpp:41-66);
    file-based ICs take each cell's nearest cloud-point state at the
    padded cell ``centers`` (..., 3), the file looked up in ``workdir``
    and then the working directory (reference: procBlock.cpp:280-320)."""
    ic = deck.ic_for_block(block_idx)
    if "file" in ic:
        from ..io.cloud import load_cloud, nearest_states
        fname = ic["file"]
        for d in filter(None, (workdir, os.getcwd())):
            cand = os.path.join(d, fname)
            if os.path.isfile(cand):
                fname = cand
                break
        pts, states = load_cloud(fname, deck, phys)
        return nearest_states(pts, states, centers)
    a, r = deck.a_ref, deck.r_ref
    rho = ic["density"] / r
    vel = [v / a for v in ic["velocity"]]
    p = ic["pressure"] / (r * a * a)

    mf = [0.0] * phys.ns
    mfm = ic.get("massFractions")
    if mfm:
        for name, frac in mfm.items():
            mf[deck.species_index(name)] = frac
    else:
        mf[0] = 1.0

    prim = np.zeros((phys.neq,) + tuple(shape))
    for s in range(phys.ns):
        prim[s] = rho * mf[s]
    prim[phys.mx] = vel[0]
    prim[phys.my] = vel[1]
    prim[phys.mz] = vel[2]
    prim[phys.ie] = p
    if phys.nturb:
        ti = ic.get("turbulenceIntensity", 0.01)
        evr = ic.get("eddyViscosityRatio", 0.01)
        vmag2 = sum(v * v for v in vel)
        tke = 1.5 * (ti * ti) * vmag2
        rho_s = torch.tensor([[rho * m] for m in mf], dtype=torch.float64)
        t = phys.temperature(torch.tensor([p], dtype=torch.float64), rho_s)
        mu = float(phys.viscosity(t, rho_s / rho)[0])
        omega = rho * tke / (evr * mu)
        tmin = phys.turb_min()
        prim[phys.it] = max(tke, tmin[0])
        prim[phys.it + 1] = max(omega, tmin[1])
    return prim


# ---------------------------------------------------------------------------
# wall distance


def viscous_wall_face_centers(geos: list, bcs: list) -> np.ndarray:
    """face centers of all viscousWall boundary faces across blocks
    (reference: utility.cpp:310 GetViscousFaceCenters)."""
    pts = []
    for geo, bc in zip(geos, bcs):
        g = geo.g
        for s in bc.surfaces:
            if s.bc_type != "viscousWall":
                continue
            fc = geo.fc(s.direction)
            idx = [None, None, None]
            rng = s.ranges()
            for a, dd in enumerate("ijk"):
                if dd == s.direction:
                    idx[a] = g + s.face_index
                else:
                    lo, hi = rng[a]
                    idx[a] = slice(g + lo, g + hi)
            pts.append(fc[tuple(idx)].reshape(-1, 3))
    if not pts:
        return np.zeros((0, 3))
    return np.concatenate(pts, axis=0)


def nearest_distance(points, queries):
    """Exact distance from each query to its nearest point: (m,) tensor.

    Brute force over all points, chunked over the queries so that one
    chunk's distance matrix stays under ``WALL_DIST_CHUNK_BYTES``; runs on
    the tensors' device.  A squared distance is the sum of the three
    squared coordinate differences in the direct difference form (no
    matrix-product expansion, which loses digits near zero), each step an
    elementwise pass over the chunk; the root is taken of the least
    one."""
    per_row = max(points.shape[0] * points.element_size(), 1)
    chunk = max(WALL_DIST_CHUNK_BYTES // per_row, 1)
    cols = points.T.contiguous()
    out = torch.empty(queries.shape[0], dtype=queries.dtype,
                      device=queries.device)
    for s in range(0, queries.shape[0], chunk):
        q = queries[s:s + chunk]
        d2 = None
        for a in range(3):
            diff = q[:, a, None] - cols[a][None, :]
            diff.mul_(diff)
            d2 = diff if d2 is None else d2.add_(diff)
        out[s:s + chunk] = torch.sqrt(d2.amin(dim=1))
    return out


def compute_wall_distance(geo: BlockGeometry, bc, wall_pts, device):
    """Wall distance (reference: procBlock.cpp:6030-6110 CalcWallDistance):
    exact nearest viscous-face distance for physical cells, searched on
    ``device``; non-edge ghosts take the NEGATIVE mirrored value across
    viscousWall boundaries and the boundary-adjacent value elsewhere
    (connection ghosts are overwritten by the swap afterwards)."""
    g = geo.g
    geo.wall_dist = np.full(geo.vol.shape, 1.0e10)
    if wall_pts.shape[0] == 0:
        return
    P = geo.phys_slice()
    centers = torch.as_tensor(geo.center[P].reshape(-1, 3), device=device)
    dist = nearest_distance(wall_pts, centers)
    geo.wall_dist[P] = dist.cpu().numpy().reshape((geo.ni, geo.nj, geo.nk))

    dims = {"i": geo.ni, "j": geo.nj, "k": geo.nk}
    for surf in bc.surfaces:
        d = surf.direction
        ax = AX[d]
        n = dims[d]
        rng = surf.ranges()
        patch = [None, None, None]
        for a in range(3):
            if a != ax:
                lo, hi = rng[a]
                patch[a] = slice(g + lo, g + hi)
        for layer in range(1, g + 1):
            idx = list(patch)
            if surf.is_lower:
                gcell, mirror, acell = g - layer, g + layer - 1, g
            else:
                gcell = g + n + layer - 1
                mirror, acell = g + n - layer, g + n - 1
            idx[ax] = gcell
            src = list(patch)
            if surf.bc_type == "viscousWall":
                src[ax] = mirror
                geo.wall_dist[tuple(idx)] = -geo.wall_dist[tuple(src)]
            else:
                src[ax] = acell
                geo.wall_dist[tuple(idx)] = geo.wall_dist[tuple(src)]


# ---------------------------------------------------------------------------
# case assembly


def build_case(deck_path: str, device, dtype=torch.float64,
               nproc: int = 1) -> Case:
    """Build the solver Case on ``device``.  nproc > 1 decomposes the grid
    into sub-blocks exactly as the JAX package (and the reference) does
    (reference: main.cpp:121-148, parallel.cpp:44-178)."""
    deck = parse_deck(deck_path).finalize()
    phys = Physics.from_deck(deck)
    case_dir = os.path.dirname(os.path.abspath(deck_path))
    grids = read_p3d(os.path.join(case_dir, deck["gridName"] + ".xyz"),
                     deck.l_ref)
    total_cells = sum((b.shape[0] - 1) * (b.shape[1] - 1) * (b.shape[2] - 1)
                      for b in grids)
    bcs = deck.bcs
    parents = decomp = None
    if nproc > 1:
        from ..parallel.decompose import decompose
        grids, bcs, decomp = decompose(grids, bcs, nproc,
                                       method=deck["decompositionMethod"])
        parents = decomp.parent
    case = assemble_case(deck, phys, grids, bcs, dtype, torch.device(device),
                         total_cells, parents=parents, workdir=case_dir)
    case.decomp = decomp
    return case


def assemble_case(deck, phys, grids, bcs, dtype, device, total_cells,
                  parents=None, workdir=None) -> Case:
    """Build a Case from node arrays + block BCs (the JAX package's
    ``assemble_case`` ordering: boundary ghost geometry -> interblock ghost
    geometry from donor nodes -> edge ghosts + widths -> wall distance),
    shared by the fine grid and the multigrid coarse levels (reference:
    gridLevel::Coarsen)."""
    g = deck.num_ghosts
    conns = conn_mod.find_connections(bcs, grids, deck.bc_states,
                                      l_ref=deck.l_ref)
    geos = [build_block_geometry(nodes, bc, g, finalize=False)
            for nodes, bc in zip(grids, bcs)]
    fill_interblock_geometry(geos, conns, grids, g)
    for geo in geos:
        finalize_block_geometry(geo)
    swap_maps = connection_index_maps(geos, conns, g, device)

    if deck.is_viscous:
        wall_pts = torch.as_tensor(viscous_wall_face_centers(geos, bcs),
                                   device=device)
        for geo, bc in zip(geos, bcs):
            compute_wall_distance(geo, bc, wall_pts, device)
        # connection ghosts take the donor's interior wall distance
        # (reference: gridLevel::SwapWallDist)
        wd = {b: torch.as_tensor(geo.wall_dist[None], device=device)
              for b, geo in enumerate(geos)}
        swap_connections(wd, swap_maps)
        for b, geo in enumerate(geos):
            geo.wall_dist = wd[b][0].cpu().numpy()

    if parents is None:
        parents = list(range(len(geos)))
    blocks = []
    for b, geo in enumerate(geos):
        prim0 = initial_prim(deck, phys, parents[b], geo.shape,
                             centers=geo.center, workdir=workdir)
        geom, geom_host = device_geometry(geo, dtype, device)
        blocks.append(Block(
            index=b, parent=parents[b], ni=geo.ni, nj=geo.nj, nk=geo.nk,
            g=g, geom=geom, geom_host=geom_host,
            surfaces=_surface_specs(deck, bcs[b], g),
            # a cloud state's gather is not C-ordered; the kernels take
            # contiguous arrays, and clones keep the layout
            prim0=torch.as_tensor(np.ascontiguousarray(prim0), dtype=dtype,
                                  device=device)))
    return Case(deck=deck, phys=phys, blocks=blocks, connections=conns,
                total_cells=total_cells, dtype=dtype, device=device,
                swap_maps=swap_maps, grids=grids, bcs=bcs)


def device_geometry(geo: BlockGeometry, dtype, device):
    """The geometry dict twice from the same host arrays: torch tensors on
    ``device`` for the compute path and a numpy mirror for host consumers
    (the JAX package's ``_device_geometry`` layout: unit normals (3, ...)
    and magnitudes per face direction, centers (3, ...))."""
    def unit_and_mag(fa):
        mag = np.sqrt((fa * fa).sum(axis=-1))
        unit = np.where(mag[..., None] > 0.0, fa / np.where(
            mag[..., None] > 0.0, mag[..., None], 1.0), 0.0)
        return (np.moveaxis(unit, -1, 0), mag)

    n_i, mag_i = unit_and_mag(geo.fa_i)
    n_j, mag_j = unit_and_mag(geo.fa_j)
    n_k, mag_k = unit_and_mag(geo.fa_k)
    host = dict(
        vol=geo.vol,
        center=np.moveaxis(geo.center, -1, 0),
        n_i=n_i, mag_i=mag_i, n_j=n_j, mag_j=mag_j, n_k=n_k, mag_k=mag_k,
        fc_i=np.moveaxis(geo.fc_i, -1, 0),
        fc_j=np.moveaxis(geo.fc_j, -1, 0),
        fc_k=np.moveaxis(geo.fc_k, -1, 0),
        width_i=geo.width_i, width_j=geo.width_j, width_k=geo.width_k,
        wall_dist=geo.wall_dist if geo.wall_dist is not None
        else np.full_like(geo.vol, 1.0e10),
    )
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    host = {k: np.ascontiguousarray(v, dtype=np_dtype)
            for k, v in host.items()}
    device_d = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    return device_d, host
