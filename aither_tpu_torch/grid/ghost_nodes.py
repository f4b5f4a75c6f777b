"""Interblock ghost geometry from donor nodes.

For a point-matched connection the acceptor's ghost cells ARE the donor's
interior cells, so the exact ghost metrics (volumes, centroids, face
areas/centers) follow from mapping the donor's node coordinates into the
acceptor's ghost index space and running the standard metric formulas
(equivalent to the reference's geomSlice swap, procBlock.cpp:3167+, without
the per-face sign bookkeeping).

Node mapping follows the cell mapping of GetSwapLoc
(boundaryConditions.cpp:3006-3180): depth ℓ from the boundary maps to depth
ℓ into the donor; in-plane axes swap for orientations {2,4,5,7} and reverse
per the orientation/patch-normal rules.
"""

from __future__ import annotations

import numpy as np

from .connections import Connection, PatchSide, AX, _noswap_flipsets
from .geometry import (BlockGeometry, cell_volumes, cell_centroids,
                       face_areas, face_centers)


def _inplane_map(conn: Connection, acceptor_is_first: bool):
    """Returns fn(l1, l2) -> (donor_d1, donor_d2) offsets in node index
    space, given FIRST-frame offsets... both directions handled by
    composing/inverting the orientation transform."""
    o = conn.orientation
    swap = o in (2, 4, 5, 7)
    second_dir = conn.second.direction
    f1set, f2set = _noswap_flipsets(second_dir)

    def first_to_second(l1, l2, len1, len2):
        # lengths are the FIRST patch's d1/d2 node extents
        if swap:
            # second.d2 <- l1 (rev for 5,7); second.d1 <- l2 (rev for 4,7)
            s2 = (len1 - l1) if o in (5, 7) else l1
            s1 = (len2 - l2) if o in (4, 7) else l2
        else:
            s1 = (len1 - l1) if o in f1set else l1
            s2 = (len2 - l2) if o in f2set else l2
        return s1, s2

    def second_to_first(s1, s2, len1, len2):
        # invert: lengths still refer to the FIRST patch's extents
        if swap:
            l1 = (len1 - s2) if o in (5, 7) else s2
            l2 = (len2 - s1) if o in (4, 7) else s1
        else:
            l1 = (len1 - s1) if o in f1set else s1
            l2 = (len2 - s2) if o in f2set else s2
        return l1, l2

    return first_to_second if acceptor_is_first else second_to_first


def fill_interblock_geometry(geos: list, conns: list, grids: list, g: int):
    """Overwrite each connection side's ghost-slab metrics with exact values
    computed from donor node coordinates.

    INTERBLOCK connections only, exactly like the reference
    (gridLevel.cpp:67-73 swaps geometry only when conn.IsInterblock()):
    periodic connections keep the MIRRORED ghost geometry from
    assign_ghost_geometry — the donor's nodes live on the far side of the
    periodic transform, so metrics computed from them are only valid
    after applying the translation/rotation; the reference never does
    that, it mirrors (procBlock.cpp:2201-2263 'including periodic')."""
    for conn in conns:
        if not conn.is_interblock:
            continue
        for acceptor, donor, acc_is_first in ((conn.first, conn.second, True),
                                              (conn.second, conn.first,
                                               False)):
            _fill_one_side(geos, grids, conn, acceptor, donor, acc_is_first,
                           g)


def _fill_one_side(geos, grids, conn, acceptor: PatchSide, donor: PatchSide,
                   acc_is_first: bool, g: int):
    geo: BlockGeometry = geos[acceptor.block]
    donor_nodes = grids[donor.block]          # (nd1+1, nd2+1, nd3+1, 3)
    dims_a = {"i": geo.ni, "j": geo.nj, "k": geo.nk}
    gd = geos[donor.block]
    dims_d = {"i": gd.ni, "j": gd.nj, "k": gd.nk}

    n_a = dims_a[acceptor.direction]
    n_d = dims_d[donor.direction]

    # trimmed in-plane node extent (cells patch±g limited by border flags,
    # then clamped to donor's physical nodes)
    border = conn.border_first if acc_is_first else conn.border_second
    e = [0 if border[i] else g for i in range(4)]

    a1_lo = acceptor.d1_range[0] - e[0]
    a1_hi = acceptor.d1_range[1] + e[1]
    a2_lo = acceptor.d2_range[0] - e[2]
    a2_hi = acceptor.d2_range[1] + e[3]

    # first-frame patch node extents (offsets relative to patch start)
    first = conn.first
    len1 = first.d1_range[1] - first.d1_range[0]
    len2 = first.d2_range[1] - first.d2_range[0]
    mapper = _inplane_map(conn, acc_is_first)

    # donor in-plane index from acceptor in-plane offset
    def donor_inplane(off1, off2):
        d1_off, d2_off = mapper(off1, off2, len1, len2)
        return donor.d1_range[0] + d1_off, donor.d2_range[0] + d2_off

    # clamp the extent so all mapped donor nodes exist
    def donor_ok(off1, off2):
        dd1, dd2 = donor_inplane(off1, off2)
        nd1 = dims_d[donor.d1]
        nd2 = dims_d[donor.d2]
        return 0 <= dd1 <= nd1 and 0 <= dd2 <= nd2

    while a1_lo < acceptor.d1_range[0] and not (
            donor_ok(a1_lo - acceptor.d1_range[0], 0)
            and donor_ok(a1_lo - acceptor.d1_range[0], a2_hi
                         - acceptor.d2_range[0])):
        a1_lo += 1
    while a1_hi > acceptor.d1_range[1] and not (
            donor_ok(a1_hi - acceptor.d1_range[0], 0)
            and donor_ok(a1_hi - acceptor.d1_range[0],
                         a2_hi - acceptor.d2_range[0])):
        a1_hi -= 1
    while a2_lo < acceptor.d2_range[0] and not (
            donor_ok(0, a2_lo - acceptor.d2_range[0])
            and donor_ok(a1_hi - acceptor.d1_range[0],
                         a2_lo - acceptor.d2_range[0])):
        a2_lo += 1
    while a2_hi > acceptor.d2_range[1] and not (
            donor_ok(0, a2_hi - acceptor.d2_range[0])
            and donor_ok(a1_hi - acceptor.d1_range[0],
                         a2_hi - acceptor.d2_range[0])):
        a2_hi -= 1

    m1 = a1_hi - a1_lo
    m2 = a2_hi - a2_lo
    if m1 <= 0 or m2 <= 0:
        return

    # build ghost node block: (g+1) node layers outward from the boundary
    off1 = np.arange(a1_lo - acceptor.d1_range[0],
                     a1_hi - acceptor.d1_range[0] + 1)
    off2 = np.arange(a2_lo - acceptor.d2_range[0],
                     a2_hi - acceptor.d2_range[0] + 1)
    O1, O2 = np.meshgrid(off1, off2, indexing="ij")
    D1, D2 = mapper(O1, O2, len1, len2)
    D1 = D1 + donor.d1_range[0]
    D2 = D2 + donor.d2_range[0]

    ghost_nodes = np.empty((g + 1, m1 + 1, m2 + 1, 3))
    for el in range(g + 1):
        # donor node depth ℓ inward from its boundary
        if donor.lower:
            d3 = el
        else:
            d3 = n_d - el
        idx = [None, None, None]
        idx[AX[donor.direction]] = d3
        idx[AX[donor.d1]] = D1
        idx[AX[donor.d2]] = D2
        ghost_nodes[el] = donor_nodes[tuple(idx)]

    # assemble a (g+1, m1+1, m2+1) node block ordered outward along the
    # acceptor's normal; for the LOWER side outward = decreasing index, so
    # metrics computed on the flipped block then flipped back
    if acceptor.lower:
        node_blk = ghost_nodes[::-1]          # increasing acceptor axis
    else:
        node_blk = ghost_nodes

    # nodes in (normal, d1, d2) order -> rearrange into (i, j, k) order
    order = [AX[acceptor.direction], AX[acceptor.d1], AX[acceptor.d2]]
    inv = np.argsort(order)
    node_ijk = np.transpose(node_blk, tuple(list(inv) + [3]))

    vol = cell_volumes(node_ijk)
    cen = cell_centroids(node_ijk)
    fas = {d: face_areas(node_ijk, d) for d in "ijk"}
    fcs = {d: face_centers(node_ijk, d) for d in "ijk"}

    # destination slices in padded arrays
    ax = AX[acceptor.direction]
    if acceptor.lower:
        cell_sl = slice(0, g)
        face_sl = slice(0, g + 1)
    else:
        cell_sl = slice(g + n_a, 2 * g + n_a)
        face_sl = slice(g + n_a, 2 * g + n_a + 1)
    in1 = slice(g + a1_lo, g + a1_hi)
    in2 = slice(g + a2_lo, g + a2_hi)
    in1f = slice(g + a1_lo, g + a1_hi + 1)
    in2f = slice(g + a2_lo, g + a2_hi + 1)

    def dst(axis_sel, f_norm=False, f1=False, f2=False):
        out = [None, None, None]
        out[ax] = face_sl if f_norm else cell_sl
        out[AX[acceptor.d1]] = in1f if f1 else in1
        out[AX[acceptor.d2]] = in2f if f2 else in2
        return tuple(out)

    geo.vol[dst(None)] = vol
    geo.center[dst(None)] = cen
    for d in "ijk":
        f_norm = d == acceptor.direction
        f1 = d == acceptor.d1
        f2 = d == acceptor.d2
        geo.fa(d)[dst(None, f_norm, f1, f2)] = fas[d]
        geo.fc(d)[dst(None, f_norm, f1, f2)] = fcs[d]
