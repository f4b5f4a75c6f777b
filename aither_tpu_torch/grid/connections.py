"""Interblock / periodic connections between block boundary patches.

Re-design of the reference's connection machinery (reference:
boundaryConditions.cpp:552-730 GetConnectionBCs/TestPatchMatch,
:3006-3180 GetSwapLoc, multiArray3d.hpp:790-940 SwapSlice/InsertSlice):

 * patches are matched geometrically by comparing the 4 patch corners,
   yielding one of 8 relative orientations,
 * a halo swap copies a ghost-extended slab of interior cells from the donor
   block into the acceptor's ghost region, transformed by
   transpose/flip per the orientation.

Copy of ``aither_tpu/grid/connections.py`` for the PyTorch port (the port
imports nothing of the JAX package); the only change is that the
orientation helpers take numpy arrays only.

Orientation semantics (matching GetSwapLoc):
  swap d1/d2 for orientations {2, 4, 5, 7};
  with swap:   second.d2 runs reverse of first.d1 for {5, 7},
               second.d1 runs reverse of first.d2 for {4, 7};
  without:     second.d1 reverse of first.d1 for {6, 8},
               second.d2 reverse of first.d2 for {3, 8};
  direction-3 order reverses when both sides are lower or both upper.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.deck import BlockBC, BoundarySurface

# patch direction-1/2 for each surface normal (reference boundarySurface
# convention: i-surface -> d1=j, d2=k; j-surface -> d1=k, d2=i;
# k-surface -> d1=i, d2=j)
PATCH_DIRS = {"i": ("j", "k"), "j": ("k", "i"), "k": ("i", "j")}
AX = {"i": 0, "j": 1, "k": 2}


def surface_number(surf: BoundarySurface) -> int:
    """1-6 surface id: il=1, iu=2, jl=3, ju=4, kl=5, ku=6."""
    base = {"i": 1, "j": 3, "k": 5}[surf.direction]
    return base if surf.is_lower else base + 1


@dataclasses.dataclass
class PatchSide:
    """One side of a connection."""

    block: int
    direction: str          # surface normal direction
    lower: bool
    const_face: int         # face index of the boundary (unpadded)
    d1: str
    d2: str
    d1_range: tuple         # (start, end) cell range (unpadded)
    d2_range: tuple
    tag: int = 0

    @property
    def surface_number(self):
        base = {"i": 1, "j": 3, "k": 5}[self.direction]
        return base if self.lower else base + 1


@dataclasses.dataclass
class Connection:
    first: PatchSide
    second: PatchSide
    orientation: int
    is_interblock: bool = True     # False = periodic
    # border flags: True when the patch's d1/d2 start/end border another
    # connection (suppresses corner-ghost insertion there)
    border_first: tuple = (False, False, False, False)
    border_second: tuple = (False, False, False, False)

    @property
    def both_lower_or_both_upper(self):
        return self.first.lower == self.second.lower


def _patch_side(block_id: int, surf: BoundarySurface) -> PatchSide:
    d1, d2 = PATCH_DIRS[surf.direction]
    rng = surf.ranges()
    return PatchSide(
        block=block_id, direction=surf.direction, lower=surf.is_lower,
        const_face=surf.face_index, d1=d1, d2=d2,
        d1_range=rng[AX[d1]], d2_range=rng[AX[d2]], tag=surf.tag)


def _patch_corners(nodes: np.ndarray, side: PatchSide):
    """origin / corner1 (d1 end) / corner2 (d2 end) / corner12 node coords
    (reference: boundaryConditions.hpp:156-215 patch geometry)."""
    idx = [None, None, None]
    idx[AX[side.direction]] = side.const_face

    def corner(at1, at2):
        i = list(idx)
        i[AX[side.d1]] = side.d1_range[1] if at1 else side.d1_range[0]
        i[AX[side.d2]] = side.d2_range[1] if at2 else side.d2_range[0]
        return nodes[tuple(i)]

    return (corner(False, False), corner(True, False),
            corner(False, True), corner(True, True))


def _corners_match(c1, c2, tol=1.0e-10) -> bool:
    return bool(np.all(np.abs(np.asarray(c1) - np.asarray(c2)) < tol))


def match_orientation(corners1, corners2) -> int | None:
    """Determine the relative orientation of two matched patches from their
    corners (reference: boundaryConditions.cpp:729-833). Returns 1-8 or
    None when the patches don't coincide."""
    o1, c1_1, c2_1, c12_1 = corners1
    o2, c1_2, c2_2, c12_2 = corners2
    if _corners_match(o1, o2):
        if _corners_match(c1_1, c1_2) and _corners_match(c2_1, c2_2):
            return 1
        if _corners_match(c1_1, c2_2) and _corners_match(c2_1, c1_2):
            return 2
    elif _corners_match(o1, c1_2):
        if _corners_match(c1_1, o2) and _corners_match(c2_1, c12_2):
            return 3
        if _corners_match(c1_1, c12_2) and _corners_match(c2_1, o2):
            return 4
    elif _corners_match(o1, c2_2):
        if _corners_match(c1_1, o2) and _corners_match(c2_1, c12_2):
            return 5
        if _corners_match(c1_1, c12_2) and _corners_match(c2_1, o2):
            return 6
    elif _corners_match(o1, c12_2):
        if _corners_match(c1_1, c1_2) and _corners_match(c2_1, c2_2):
            return 7
        if _corners_match(c1_1, c2_2) and _corners_match(c2_1, c1_2):
            return 8
    return None


def _rotation_matrix(axis, angle):
    ax = np.asarray(axis, dtype=np.float64)
    ax = ax / np.linalg.norm(ax)
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = ax
    return np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])


def find_connections(bcs: list[BlockBC], grids: list[np.ndarray],
                     bc_states=None, l_ref: float = 1.0) -> list[Connection]:
    """Match all interblock and periodic surfaces into connections.

    interblock tags encode the partner: tag = partnerSurface*1000 +
    partnerBlock (reference: boundaryConditions.cpp:2458-2496); orientation
    comes from geometric corner matching.  periodic patches match after
    applying the translation/rotation from their boundaryState."""
    conns: list[Connection] = []
    entries = []   # (block, surf)
    for b, bc in enumerate(bcs):
        for s in bc.surfaces:
            if s.bc_type in ("interblock", "periodic"):
                entries.append((b, s))

    used = set()
    for n, (b1, s1) in enumerate(entries):
        if n in used:
            continue
        side1 = _patch_side(b1, s1)
        found = False
        for m in range(len(entries)):
            if m == n or m in used:
                continue
            b2, s2 = entries[m]
            if s1.bc_type != s2.bc_type:
                continue
            side2 = _patch_side(b2, s2)
            if s1.bc_type == "interblock":
                # partner check via tag encoding
                ps1, pb1 = divmod(s1.tag, 1000)
                if pb1 != b2 or ps1 != side2.surface_number:
                    continue
                c1 = _patch_corners(grids[b1], side1)
                c2 = _patch_corners(grids[b2], side2)
            else:  # periodic: transform the start-tag corners by the
                # boundaryState's translation/rotation, whichever side is
                # visited first (reference: boundaryConditions.cpp periodic
                # matching via the transformed patch)
                if bc_states is None:
                    continue
                try:
                    data = _periodic_data(bc_states, s1.tag)
                except KeyError:
                    continue
                fwd = (data.get("startTag") == s1.tag
                       and data.get("endTag") == s2.tag)
                rev = (data.get("endTag") == s1.tag
                       and data.get("startTag") == s2.tag)
                if not (fwd or rev):
                    continue
                c1 = [np.asarray(c, dtype=np.float64)
                      for c in _patch_corners(grids[b1], side1)]
                sgn = 1.0 if fwd else -1.0
                if "translation" in data:
                    tr = np.asarray(data["translation"],
                                    dtype=np.float64) / l_ref
                    c1 = [c + sgn * tr for c in c1]
                else:
                    rot = _rotation_matrix(data["axis"],
                                           sgn * data["rotation"])
                    pt = np.asarray(data["point"], dtype=np.float64) / l_ref
                    c1 = [rot @ (c - pt) + pt for c in c1]
                c2 = _patch_corners(grids[b2], side2)
            orient = match_orientation(c1, c2)
            if orient is None:
                continue
            conns.append(Connection(first=side1, second=side2,
                                    orientation=orient,
                                    is_interblock=(s1.bc_type == "interblock")))
            used.add(n)
            used.add(m)
            found = True
            break
        if not found and n not in used:
            raise ValueError(
                f"no connection match for block {b1} surface {s1}")

    _set_border_flags(conns, bcs)
    return conns


def _periodic_data(bc_states, tag):
    for st in bc_states:
        if st.get("startTag") == tag or st.get("endTag") == tag:
            d = dict(st.params)
            return d
    raise KeyError(tag)


def _borders_surface(side: PatchSide, bcs: list[BlockBC]):
    """[d1Start, d1End, d2Start, d2End] True where the patch abuts another
    surface on the same block face (reference:
    boundaryConditions.cpp:193-260 BordersSurface): the swap skips the
    ghost-extended corners on those sides."""
    f = [False, False, False, False]
    for other in bcs[side.block].surfaces:
        if other.direction != side.direction or other.is_lower != side.lower \
                or other.face_index != side.const_face:
            continue
        rng = other.ranges()
        o_d1 = rng[AX[side.d1]]
        o_d2 = rng[AX[side.d2]]
        if o_d1 == side.d1_range and o_d2 == side.d2_range:
            continue  # the patch itself
        # border along d1
        if side.d1_range[0] == o_d1[1]:
            f[0] = True
        if side.d1_range[1] == o_d1[0]:
            f[1] = True
        # border along d2
        if side.d2_range[0] == o_d2[1]:
            f[2] = True
        if side.d2_range[1] == o_d2[0]:
            f[3] = True
    return tuple(f)


def _set_border_flags(conns: list[Connection], bcs: list[BlockBC]):
    for c in conns:
        c.border_first = _borders_surface(c.first, bcs)
        c.border_second = _borders_surface(c.second, bcs)


# ---------------------------------------------------------------------------
# slab transforms


def _noswap_flipsets(second_dir: str):
    """orientation sets that reverse d1/d2 in the no-swap branch.

    GetSwapLoc (boundaryConditions.cpp:3006-3180) uses {6,8} on d1 and
    {3,8} on d2 when the second patch is i-normal, but {3,8} on d1 and
    {6,8} on d2 for j/k-normal patches."""
    if second_dir == "i":
        return (6, 8), (3, 8)
    return (3, 8), (6, 8)


def orient_to_first(donor, orientation: int, axis1: int, axis2: int,
                    second_dir: str = "i"):
    """Reorient a donor slab (indexed in the second patch's d1/d2 axes) into
    the first patch's frame.  axis1/axis2 are the array axes of the donor
    corresponding to the *second* patch's d1/d2."""
    swap = orientation in (2, 4, 5, 7)
    if swap:
        # first.d1 -> second.d2 (reversed for 5,7); first.d2 -> second.d1
        # (reversed for 4,7)
        if orientation in (5, 7):
            donor = _jflip(donor, axis2)
        if orientation in (4, 7):
            donor = _jflip(donor, axis1)
        donor = _swapaxes(donor, axis1, axis2)
    else:
        f1, f2 = _noswap_flipsets(second_dir)
        if orientation in f1:
            donor = _jflip(donor, axis1)
        if orientation in f2:
            donor = _jflip(donor, axis2)
    return donor


def orient_to_second(donor, orientation: int, axis1: int, axis2: int,
                     second_dir: str = "i"):
    """Inverse of orient_to_first: donor indexed in the first patch's d1/d2
    axes, reoriented into the second patch's frame."""
    swap = orientation in (2, 4, 5, 7)
    if swap:
        donor = _swapaxes(donor, axis1, axis2)
        # after the transpose, axis1 holds second.d1 etc.
        if orientation in (5, 7):
            donor = _jflip(donor, axis2)
        if orientation in (4, 7):
            donor = _jflip(donor, axis1)
    else:
        f1, f2 = _noswap_flipsets(second_dir)
        if orientation in f1:
            donor = _jflip(donor, axis1)
        if orientation in f2:
            donor = _jflip(donor, axis2)
    return donor


def _jflip(a, axis):
    # the port orients numpy (host index) arrays only
    return np.flip(a, axis=axis)


def _swapaxes(a, ax1, ax2):
    return np.swapaxes(a, ax1, ax2)
