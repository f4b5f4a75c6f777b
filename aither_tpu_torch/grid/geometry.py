"""Block geometry: metrics + ghost-cell geometry.

Host-side (NumPy) one-time precompute.  Cell volumes / centroids / face
areas / face centers follow the reference formulas (reference:
src/plot3d.cpp:36-338, PyramidVolume at :490), and the ghost-geometry
protocol mirrors procBlock::AssignGhostCellsGeom / ...GeomEdge
(reference: src/procBlock.cpp:2160-2435):

  * ghost volumes & face areas are mirrored from interior cells,
  * ghost centroids / face centers are extended outward by interior spacing,
  * edge (corner) ghosts take values from "direction 2" mirroring.

Arrays are padded with ``g`` ghost layers on every side.  Index convention:
padded index = interior index + g; physical cells span [g, g+n).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.deck import BlockBC

# axis number within (ni, nj, nk) arrays for each direction
AX = {"i": 0, "j": 1, "k": 2}
# cyclic direction-1/2 for a given direction-3 (reference boundarySurface
# convention: i-surface -> d1=j, d2=k; j -> d1=k, d2=i; k -> d1=i, d2=j)
D1 = {"i": "j", "j": "k", "k": "i"}
D2 = {"i": "k", "j": "i", "k": "j"}


def pyramid_volume(p, a, b, c, d):
    """Volume of pyramid with peak p and quadrilateral base a-b-c-d
    (reference: plot3d.cpp:490-498)."""
    xp = 0.25 * ((a - p) + (b - p) + (c - p) + (d - p))
    xac = c - a
    xbd = d - b
    cross = np.cross(xac, xbd)
    return (xp * cross).sum(axis=-1) / 6.0


def cell_centroids(nodes: np.ndarray) -> np.ndarray:
    """(ni,nj,nk,3) centroids from (ni+1,nj+1,nk+1,3) nodes."""
    return 0.125 * (
        nodes[:-1, :-1, :-1] + nodes[1:, :-1, :-1] + nodes[:-1, 1:, :-1]
        + nodes[1:, 1:, :-1] + nodes[:-1, :-1, 1:] + nodes[1:, :-1, 1:]
        + nodes[:-1, 1:, 1:] + nodes[1:, 1:, 1:])


def cell_volumes(nodes: np.ndarray) -> np.ndarray:
    """Hexahedron volumes via 6 pyramids from the centroid
    (reference: plot3d.cpp:60-105)."""
    c = cell_centroids(nodes)
    n = nodes
    vol = pyramid_volume(c, n[:-1, :-1, :-1], n[:-1, :-1, 1:],
                         n[:-1, 1:, 1:], n[:-1, 1:, :-1])          # i-lower
    vol += pyramid_volume(c, n[1:, :-1, :-1], n[1:, 1:, :-1],
                          n[1:, 1:, 1:], n[1:, :-1, 1:])           # i-upper
    vol += pyramid_volume(c, n[:-1, :-1, :-1], n[1:, :-1, :-1],
                          n[1:, :-1, 1:], n[:-1, :-1, 1:])         # j-lower
    vol += pyramid_volume(c, n[:-1, 1:, :-1], n[:-1, 1:, 1:],
                          n[1:, 1:, 1:], n[1:, 1:, :-1])           # j-upper
    vol += pyramid_volume(c, n[:-1, :-1, :-1], n[:-1, 1:, :-1],
                          n[1:, 1:, :-1], n[1:, :-1, :-1])         # k-lower
    vol += pyramid_volume(c, n[:-1, :-1, 1:], n[1:, :-1, 1:],
                          n[1:, 1:, 1:], n[:-1, 1:, 1:])           # k-upper
    return vol


def face_areas(nodes: np.ndarray, d: str) -> np.ndarray:
    """Face area vectors normal to direction d, as half the cross product of
    the face diagonals (reference: plot3d.cpp:137-338).  Normal points toward
    increasing d."""
    n = nodes
    if d == "i":
        xac = n[:, 1:, 1:] - n[:, :-1, :-1]
        xbd = n[:, 1:, :-1] - n[:, :-1, 1:]
    elif d == "j":
        xac = n[:-1, :, 1:] - n[1:, :, :-1]
        xbd = n[:-1, :, :-1] - n[1:, :, 1:]
    else:
        xac = n[:-1, 1:, :] - n[1:, :-1, :]
        xbd = n[1:, 1:, :] - n[:-1, :-1, :]
    return 0.5 * np.cross(xbd, xac)


def face_centers(nodes: np.ndarray, d: str) -> np.ndarray:
    n = nodes
    if d == "i":
        return 0.25 * (n[:, :-1, :-1] + n[:, 1:, :-1] + n[:, :-1, 1:]
                       + n[:, 1:, 1:])
    if d == "j":
        return 0.25 * (n[:-1, :, :-1] + n[1:, :, :-1] + n[:-1, :, 1:]
                       + n[1:, :, 1:])
    return 0.25 * (n[:-1, :-1, :] + n[1:, :-1, :] + n[:-1, 1:, :]
                   + n[1:, 1:, :])


@dataclasses.dataclass
class BlockGeometry:
    """Padded geometry for one block; all arrays are NumPy float64.

    Face arrays have one extra entry along their own direction.  ``fa_*``
    are raw area vectors (..., 3); unit normals are fa/|fa|."""

    g: int                      # number of ghost layers
    ni: int
    nj: int
    nk: int
    vol: np.ndarray             # (NI, NJ, NK)
    center: np.ndarray          # (NI, NJ, NK, 3)
    fa_i: np.ndarray            # (NI+1, NJ, NK, 3)
    fa_j: np.ndarray            # (NI, NJ+1, NK, 3)
    fa_k: np.ndarray            # (NI, NJ, NK+1, 3)
    fc_i: np.ndarray            # (NI+1, NJ, NK, 3)
    fc_j: np.ndarray
    fc_k: np.ndarray
    width_i: np.ndarray = None  # (NI, NJ, NK) set by compute_widths
    width_j: np.ndarray = None
    width_k: np.ndarray = None
    wall_dist: np.ndarray = None

    @property
    def shape(self):
        return self.vol.shape

    def phys_slice(self):
        g = self.g
        return (slice(g, g + self.ni), slice(g, g + self.nj),
                slice(g, g + self.nk))

    def fa(self, d):
        return {"i": self.fa_i, "j": self.fa_j, "k": self.fa_k}[d]

    def fc(self, d):
        return {"i": self.fc_i, "j": self.fc_j, "k": self.fc_k}[d]

    def width(self, d):
        return {"i": self.width_i, "j": self.width_j, "k": self.width_k}[d]

    def compute_widths(self):
        """Cell widths = distance between opposite face centers, over all
        padded cells (reference: procBlock.cpp:6397-6411)."""
        def dist(fc, ax):
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[ax] = slice(0, -1)
            hi[ax] = slice(1, None)
            d = fc[tuple(hi)] - fc[tuple(lo)]
            return np.sqrt((d * d).sum(axis=-1))
        self.width_i = dist(self.fc_i, 0)
        self.width_j = dist(self.fc_j, 1)
        self.width_k = dist(self.fc_k, 2)


def _cell_index(g, n, d, side, layer):
    """Padded ghost/interior/previous cell indices for a boundary layer.

    Returns (gcell, icell, pcell) padded indices following
    procBlock.cpp:2174-2198 (icell clamped into the physical range)."""
    if side == "lower":
        gcell = g - layer
        icell = min(g + layer - 1, g + n - 1)
        pcell = gcell + 1
    else:
        gcell = g + n + layer - 1
        icell = max(g + n - layer, g)
        pcell = gcell - 1
    return gcell, icell, pcell


def assign_ghost_geometry(geo: BlockGeometry, bc: BlockBC):
    """Fill ghost geometry from boundary surfaces
    (reference: procBlock.cpp:2160-2263).  Interblock surfaces are skipped;
    their geometry is swapped from the neighbor block elsewhere."""
    g = geo.g
    dims = {"i": geo.ni, "j": geo.nj, "k": geo.nk}

    for layer in range(1, g + 1):
        for surf in bc.surfaces:
            if surf.bc_type == "interblock":
                continue
            d = surf.direction
            ax = AX[d]
            n = dims[d]
            side = "lower" if surf.is_lower else "upper"
            gcell, icell, pcell = _cell_index(g, n, d, side, layer)

            # patch ranges (cell index ranges in the other two axes, padded)
            rng = surf.ranges()
            patch = [None, None, None]
            for dd in "ijk":
                if dd == d:
                    continue
                lo, hi = rng[AX[dd]]
                patch[AX[dd]] = slice(g + lo, g + hi)

            def sl(idx, extra=0, axis=ax):
                """index tuple selecting `idx` on `axis` and the patch
                elsewhere; `extra` grows the patch end for face arrays."""
                out = []
                for a in range(3):
                    if a == axis:
                        out.append(idx)
                    else:
                        s = patch[a]
                        if extra and a == extra_axis:
                            s = slice(s.start, s.stop + 1)
                        out.append(s)
                return tuple(out)

            extra_axis = -1  # set per-use below

            # ---- volumes: mirror
            geo.vol[sl(gcell)] = geo.vol[sl(icell)]

            # ---- face areas
            # normal-direction faces: ghost outer face <- mirrored face
            # lower: face[g-layer] = face[g+layer-1]
            # upper: face[g+n+layer] = face[g+n-layer+1]  (clamped via icell)
            fa_d = geo.fa(d)
            if side == "lower":
                gface, iface_m = gcell, icell
            else:
                gface, iface_m = gcell + 1, icell + 1
            fa_d[sl(gface)] = fa_d[sl(iface_m)]

            # transverse faces: copy the mirrored interior cell's faces
            for dd in "ijk":
                if dd == d:
                    continue
                extra_axis = AX[dd]
                fa_t = geo.fa(dd)
                fa_t[sl(gcell, extra=1)] = fa_t[sl(icell, extra=1)]
            extra_axis = -1

            # ---- centroids & face centers, shifted outward
            fc_d = geo.fc(d)
            if side == "lower":
                iface = min(g + layer, g + n)
                piface = iface - 1
                pface = pcell  # outer (lower) face of previous cell
                gface2 = gcell
            else:
                iface = max(g + n - layer, g)
                piface = iface + 1
                pface = pcell + 1  # outer (upper) face of previous cell
                gface2 = gcell + 1

            dist_f2f = fc_d[sl(piface)] - fc_d[sl(iface)]
            if layer > 1:
                if side == "lower":
                    picell = icell - 1
                else:
                    picell = icell + 1
                dist_c2c = geo.center[sl(picell)] - geo.center[sl(icell)]
            else:
                dist_c2c = dist_f2f

            geo.center[sl(gcell)] = geo.center[sl(pcell)] + dist_c2c

            # normal-direction face centers: new outer face
            fc_d[sl(gface2)] = fc_d[sl(pface)] + dist_f2f

            # transverse face centers: shift previous ghost layer by c2c.
            # dist arrays span the patch; grow along the face direction by
            # duplicating the last entry (reference GrowJ/GrowK semantics).
            for dd in "ijk":
                if dd == d:
                    continue
                extra_axis = AX[dd]
                fc_t = geo.fc(dd)
                src = fc_t[sl(pcell, extra=1)]
                # grow dist_c2c along dd within the patch
                grow_ax = AX[dd] if AX[dd] < ax else AX[dd] - 1
                # dist_c2c has shape of patch (2 axes) + (3,)
                dist = dist_c2c
                pad = [(0, 0)] * dist.ndim
                pad[grow_ax] = (0, 1)
                dist = np.pad(dist, pad, mode="edge")
                fc_t[sl(gcell, extra=1)] = src + dist
            extra_axis = -1


def assign_ghost_geometry_edges(geo: BlockGeometry):
    """Fill edge/corner ghost geometry (reference: procBlock.cpp:2296-2435).

    For each pair of directions (d2, d3) the edge ghosts mirror along d2
    using the already-assigned d3 ghost values."""
    g = geo.g
    dims = [geo.ni, geo.nj, geo.nk]

    for dd, d in enumerate("ijk"):  # d = direction of the edge line
        ax1 = AX[d]
        d2 = D1[d]   # reference: i-line -> dir2 = j etc. (cyclic)
        d3 = D2[d]
        ax2, ax3 = AX[d2], AX[d3]
        max2, max3 = dims[ax2], dims[ax3]

        # reference slices are physOnly=true: only the physical extent along
        # the edge line is read/written (multiArray3d.hpp:475-530)
        line = slice(g, g + dims[ax1])
        line_f = slice(g, g + dims[ax1] + 1)

        for layer3 in range(1, g + 1):
            for layer2 in range(1, g + 1):
                for cc in range(4):
                    up2 = cc > 1
                    up3 = cc % 2 == 1
                    if up2:
                        pcell2 = g + max2 + layer2 - 2
                        gcell2 = pcell2 + 1
                        icell2 = g + max2 - layer2
                    else:
                        pcell2 = g + 1 - layer2
                        gcell2 = pcell2 - 1
                        icell2 = g + layer2 - 1
                    if up3:
                        pcell3 = g + max3 + layer3 - 2
                        gcell3 = pcell3 + 1
                    else:
                        pcell3 = g + 1 - layer3
                        gcell3 = pcell3 - 1

                    def sl(i2, i3, f2=0, f3=0, fl=0):
                        out = [None, None, None]
                        out[ax1] = line_f if fl else line
                        out[ax2] = i2 + f2
                        out[ax3] = i3 + f3
                        return tuple(out)

                    # volumes: mirror along d2
                    geo.vol[sl(gcell2, gcell3)] = geo.vol[sl(icell2, gcell3)]

                    # face areas: mirror along d2 with face offsets for the
                    # arrays normal to d2/d3 when on the upper side
                    for fd in "ijk":
                        fa = geo.fa(fd)
                        f2 = 1 if (fd == d2 and up2) else 0
                        f3 = 1 if (fd == d3 and up3) else 0
                        fl = 1 if fd == d else 0
                        fa[sl(gcell2, gcell3, f2, f3, fl)] = \
                            fa[sl(icell2, gcell3, f2, f3, fl)]

                    # distances
                    fc2 = geo.fc(d2)
                    f2o = 1 if up2 else 0
                    dist_f2f = (fc2[sl(gcell2, pcell3, f2o, 0)]
                                - fc2[sl(pcell2, pcell3, f2o, 0)])
                    dist_c2c = (geo.center[sl(gcell2, pcell3)]
                                - geo.center[sl(pcell2, pcell3)])

                    geo.center[sl(gcell2, gcell3)] = \
                        geo.center[sl(pcell2, gcell3)] + dist_c2c

                    for fd in "ijk":
                        fc = geo.fc(fd)
                        f2 = 1 if (fd == d2 and up2) else 0
                        f3 = 1 if (fd == d3 and up3) else 0
                        fl = 1 if fd == d else 0
                        if fd == d:
                            # grow c2c along the line by duplicating the end
                            # (after integer-indexing ax2/ax3 the remaining
                            # axes are [line, xyz])
                            pads = [(0, 0)] * dist_c2c.ndim
                            pads[0] = (0, 1)
                            dist = np.pad(dist_c2c, pads, mode="edge")
                        elif fd == d2:
                            dist = dist_f2f
                        else:
                            dist = dist_c2c
                        fc[sl(gcell2, gcell3, f2, f3, fl)] = \
                            fc[sl(pcell2, gcell3, f2, f3, fl)] + dist


def finalize_block_geometry(geo: BlockGeometry):
    """Edge ghosts + cell widths; run after any interblock geometry swap
    (ordering per reference: gridLevel.cpp:56-78)."""
    assign_ghost_geometry_edges(geo)
    geo.compute_widths()
    return geo


def build_block_geometry(nodes: np.ndarray, bc: BlockBC,
                         num_ghosts: int, finalize: bool = True) -> BlockGeometry:
    """Construct padded geometry for one block from its nodes and BCs."""
    g = num_ghosts
    ni, nj, nk = (s - 1 for s in nodes.shape[:3])
    NI, NJ, NK = ni + 2 * g, nj + 2 * g, nk + 2 * g

    geo = BlockGeometry(
        g=g, ni=ni, nj=nj, nk=nk,
        vol=np.zeros((NI, NJ, NK)),
        center=np.zeros((NI, NJ, NK, 3)),
        fa_i=np.zeros((NI + 1, NJ, NK, 3)),
        fa_j=np.zeros((NI, NJ + 1, NK, 3)),
        fa_k=np.zeros((NI, NJ, NK + 1, 3)),
        fc_i=np.zeros((NI + 1, NJ, NK, 3)),
        fc_j=np.zeros((NI, NJ + 1, NK, 3)),
        fc_k=np.zeros((NI, NJ, NK + 1, 3)),
    )
    P = geo.phys_slice()
    geo.vol[P] = cell_volumes(nodes)
    geo.center[P] = cell_centroids(nodes)
    fslice = {
        "i": (slice(g, g + ni + 1), slice(g, g + nj), slice(g, g + nk)),
        "j": (slice(g, g + ni), slice(g, g + nj + 1), slice(g, g + nk)),
        "k": (slice(g, g + ni), slice(g, g + nj), slice(g, g + nk + 1)),
    }
    for d in "ijk":
        geo.fa(d)[fslice[d]] = face_areas(nodes, d)
        geo.fc(d)[fslice[d]] = face_centers(nodes, d)

    assign_ghost_geometry(geo, bc)
    if finalize:
        finalize_block_geometry(geo)
    return geo
