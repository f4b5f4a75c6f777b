"""Host-side block decomposition for device-parallel runs.

Re-implements the reference's domain decomposition so that decomposed runs
reproduce the reference's per-processor-count convergence histories exactly:

 * cubic load balancing (reference: src/parallel.cpp:95-178
   CubicDecomposition, :641-720 SendWholeOrSplit) — greedily move or split
   the largest block from the most-overloaded toward the most-underloaded
   "processor" (here: device slot) until maxLoad/ideal <= 1.1,
 * node-grid splitting (reference: src/plot3d.cpp:451 plot3dBlock::Split),
 * boundary-surface splitting with C-grid handling
   (reference: src/boundaryConditions.cpp:1267-1453
   boundaryConditions::Split, src/boundaryConditions.cpp:2728-2860
   boundarySurface::Split),
 * dependent splitting of interblock partners
   (reference: src/boundaryConditions.cpp:1459-1706 DependentSplit,
   :2869-2935 boundarySurface::DependentSplit).

This is host-side setup code that runs once; the split (grids, bcs) feed
the standard Case assembly, whose connection matcher rebuilds the halo
swap topology from the split interblock tags.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.deck import BlockBC, BoundarySurface
from ..grid.connections import (PATCH_DIRS, AX, _patch_side, _patch_corners,
                                match_orientation)


# ---------------------------------------------------------------------------
# boundarySurface helpers (reference: boundaryConditions.hpp:55-150)


def surf_type(s: BoundarySurface) -> int:
    """1/2 = i lower/upper, 3/4 = j, 5/6 = k."""
    base = {"i": 1, "j": 3, "k": 5}[s.direction]
    return base if s.is_lower else base + 1


def partner_block(s: BoundarySurface) -> int:
    return s.tag % 1000


def partner_surface(s: BoundarySurface) -> int:
    return s.tag // 1000


def _retag(s: BoundarySurface, nblk: int) -> BoundarySurface:
    """Point an interblock surface at a new partner block
    (reference: boundarySurface::UpdateTagForSplitJoin)."""
    return dataclasses.replace(s, tag=partner_surface(s) * 1000 + nblk)


def _rng(s: BoundarySurface, d: str):
    return s.ranges()[AX[d]]


_RANGE_FIELDS = {"i": ("imin", "imax"), "j": ("jmin", "jmax"),
                 "k": ("kmin", "kmax")}


def _with_range(s: BoundarySurface, d: str, lo: int, hi: int):
    flo, fhi = _RANGE_FIELDS[d]
    return dataclasses.replace(s, **{flo: lo, fhi: hi})


def _shift(s: BoundarySurface, d: str, delta: int):
    lo, hi = _rng(s, d)
    return _with_range(s, d, lo + delta, hi + delta)


def _sort_key(s: BoundarySurface):
    """reference: boundarySurface::operator< (boundaryConditions.cpp:92)."""
    return (surf_type(s), s.imin, s.imax, s.jmin, s.jmax, s.kmin, s.kmax,
            s.tag)


def split_surface(s: BoundarySurface, d: str, ind: int,
                  rel_to_split: bool = True):
    """Split one surface at face index ``ind`` along ``d``
    (reference: boundarySurface::Split, boundaryConditions.cpp:2728).

    Returns (lower, upper, split, low): ``split`` when the surface
    straddles the cut; otherwise ``low`` says which side it lies on.
    The upper side's indices are shifted relative to the cut when
    ``rel_to_split``.
    """
    if d != s.direction:
        lo, hi = _rng(s, d)
        if lo >= ind:     # only in the upper split
            upper = _shift(s, d, -ind) if rel_to_split else s
            return None, upper, False, False
        if hi > ind:      # straddles the cut
            upper = _with_range(s, d, ind, hi)
            if rel_to_split:
                upper = _shift(upper, d, -ind)
            lower = _with_range(s, d, lo, ind)
            return lower, upper, True, False
        return s, None, False, True   # only in the lower split
    # surface normal to the split direction: belongs wholly to one side
    if ind >= s.face_index:
        return s, None, False, True
    upper = _shift(s, d, -ind) if rel_to_split else s
    return None, upper, False, False


# ---------------------------------------------------------------------------
# boundaryConditions::Split


def _cgrid_pairs(surfs, blk):
    """Pairs of same-block interblock surfaces forming a C-grid seam
    (reference: boundaryConditions::CGridPairs,
    boundaryConditions.cpp:1201-1227)."""
    pairs = []
    for ii in range(len(surfs)):
        si = surfs[ii]
        if si.bc_type != "interblock" or partner_block(si) != blk:
            continue
        for jj in range(ii + 1, len(surfs)):
            sj = surfs[jj]
            if sj.bc_type != "interblock" or partner_block(sj) != blk:
                continue
            d1i, d2i = PATCH_DIRS[si.direction]
            d1j, d2j = PATCH_DIRS[sj.direction]
            if (partner_surface(si) == partner_surface(sj)
                    and _rng(si, d1i)[1] - _rng(si, d1i)[0]
                    == _rng(sj, d1j)[1] - _rng(sj, d1j)[0]
                    and _rng(si, d2i)[1] - _rng(si, d2i)[0]
                    == _rng(sj, d2j)[1] - _rng(sj, d2j)[0]):
                pairs.append((ii, jj))
    return pairs


def _block_dims(surfs):
    """Cell dims implied by the surface list (reference:
    boundaryConditions::BlockDimI/J/K)."""
    di = max(s.imax for s in surfs)
    dj = max(s.jmax for s in surfs)
    dk = max(s.kmax for s in surfs)
    return di, dj, dk


def bc_split(bc: BlockBC, d: str, ind: int, blk: int, new_blk: int):
    """Split a block's surface list along ``d`` at ``ind``
    (reference: boundaryConditions::Split, boundaryConditions.cpp:1267).

    Returns (lower_bc, upper_bc, altered) where ``altered`` is the list of
    (position, surface) interblock entries whose partner blocks need a
    DependentSplit.
    """
    surfs = list(bc.surfaces)
    dim_i, dim_j, dim_k = _block_dims(surfs)
    pairs_idx = _cgrid_pairs(surfs, blk)
    first_of_pair = {ii: jj for ii, jj in pairs_idx}

    lower, upper, altered = [], [], []
    inserted = False
    # second members of split C-grid pairs, already pushed to the upper bc
    skip = set()

    for n, s in enumerate(surfs):
        # affected interblocks: not lower surfaces normal to the split
        # direction, not C-grid self-connections
        if (s.bc_type == "interblock"
                and not (d == s.direction and s.is_lower)
                and partner_block(s) != blk):
            altered.append((n, s))

        if not inserted and d == s.direction:
            # insert the new interface surfaces between the two halves
            st_lower = {"i": 1, "j": 3, "k": 5}[d]
            low_tag = st_lower * 1000 + new_blk
            up_tag = (st_lower + 1) * 1000 + blk
            full = {"imin": 0, "imax": dim_i, "jmin": 0, "jmax": dim_j,
                    "kmin": 0, "kmax": dim_k}
            lo_rng = dict(full)
            flo, fhi = _RANGE_FIELDS[d]
            lo_rng[flo] = lo_rng[fhi] = ind
            lower.append(BoundarySurface(
                "interblock", lo_rng["imin"], lo_rng["imax"], lo_rng["jmin"],
                lo_rng["jmax"], lo_rng["kmin"], lo_rng["kmax"], tag=low_tag,
                direction=d))
            up_rng = dict(full)
            up_rng[flo] = up_rng[fhi] = 0
            upper.append(BoundarySurface(
                "interblock", up_rng["imin"], up_rng["imax"], up_rng["jmin"],
                up_rng["jmax"], up_rng["kmin"], up_rng["kmax"], tag=up_tag,
                direction=d))
            inserted = True

        if n in skip:
            continue

        # C-grid seam handling (reference: boundaryConditions.cpp:1367-1405):
        # when the first seam surface straddles the cut, the (reversed)
        # partner seam surface splits at the mirrored index and both of its
        # halves belong to the upper block — the lower-matching half keeps
        # partnering the lower (old) block, the rest becomes an upper-block
        # self-connection; the straddling surface itself is retagged to the
        # new block and split by the normal path below.
        if n in first_of_pair:
            _, _, split, low = split_surface(s, d, ind)
            if split:
                jj = first_of_pair[n]
                part = surfs[jj]
                rev_ind = _rng(part, d)[1] - ind
                p_lo, p_up, _, _ = split_surface(part, d, rev_ind,
                                                 rel_to_split=False)
                p_lo = _retag(p_lo, new_blk)
                upper.append(_shift(p_lo, d, -ind))
                upper.append(_shift(p_up, d, -ind))
                skip.add(jj)
                s = _retag(s, new_blk)
            elif low:
                # seam broken across the two blocks: the lower surface now
                # partners the new (upper) block
                s = _retag(s, new_blk)

        lo_s, up_s, split, low = split_surface(s, d, ind)
        if split:
            lower.append(lo_s)
            upper.append(up_s)
        elif low:
            lower.append(lo_s)
        else:
            upper.append(up_s)

    lower.sort(key=_sort_key)
    upper.sort(key=_sort_key)
    return _mk_bc(lower), _mk_bc(upper), altered


def _mk_bc(surfs) -> BlockBC:
    ni = sum(1 for s in surfs if s.direction == "i")
    nj = sum(1 for s in surfs if s.direction == "j")
    nk = sum(1 for s in surfs if s.direction == "k")
    return BlockBC(ni, nj, nk, surfs)


# ---------------------------------------------------------------------------
# DependentSplit


def _split_dir_is_reversed(s: BoundarySurface, d: str, orientation: int):
    """reference: boundarySurface::SplitDirectionIsReversed
    (boundaryConditions.cpp:2957-2998)."""
    d1, d2 = PATCH_DIRS[s.direction]
    if d1 == d:
        return orientation in (3, 5, 7, 8)
    if d2 == d:
        return orientation in (4, 6, 7, 8)
    return False


def surface_dependent_split(s: BoundarySurface, d: str, ind: int, sblk: int,
                            lblk: int, ublk: int, orientation: int):
    """Split/retag a surface whose interblock partner was split
    (reference: boundarySurface::DependentSplit,
    boundaryConditions.cpp:2869-2935).  Returns (lower, upper, split, low)
    with tags updated; indices are NOT shifted (the block itself did not
    split)."""
    is_reversed = _split_dir_is_reversed(s, d, orientation)
    # C-grid split into an H-grid: self is one of the split halves
    split_cgrid = (sblk in (lblk, ublk)) and d != s.direction

    lo_s, up_s, split, low = split_surface(s, d, ind, rel_to_split=False)

    if split_cgrid:
        if split:
            if sblk == lblk:
                lblk = ublk
            else:
                ublk = lblk
        elif low:
            if sblk == lblk:
                lblk = ublk
        else:
            if sblk == ublk:
                ublk = lblk
    elif is_reversed and split:
        lblk, ublk = ublk, lblk

    if split:
        return _retag(lo_s, lblk), _retag(up_s, ublk), True, False
    if low:
        return _retag(lo_s, lblk), None, False, True
    return None, _retag(up_s, ublk), False, False


def bc_dependent_split(bc: BlockBC, part_surf: BoundarySurface,
                       self_surf: BoundarySurface, orientation: int,
                       sblk: int, d: str, ind: int, lblk: int, ublk: int):
    """Update a partner block's surface list after its neighbour split
    (reference: boundaryConditions::DependentSplit,
    boundaryConditions.cpp:1459-1706)."""
    surfs = list(bc.surfaces)
    idx = surfs.index(self_surf)

    pd1, pd2 = PATCH_DIRS[part_surf.direction]
    sd1, sd2 = PATCH_DIRS[self_surf.direction]
    swap = orientation in (2, 4, 5, 7)
    if d == pd1:
        cand_dir = sd2 if swap else sd1
        self_min = _rng(self_surf, cand_dir)[0]
        plo, phi = _rng(part_surf, pd1)
        rev = orientation in ((4, 7) if swap else (3, 8))
        cand_ind = (phi - ind - plo + self_min) if rev \
            else (ind - plo + self_min)
    elif d == pd2:
        cand_dir = sd1 if swap else sd2
        self_min = _rng(self_surf, cand_dir)[0]
        plo, phi = _rng(part_surf, pd2)
        rev = orientation in ((5, 7) if swap else (6, 8))
        cand_ind = (phi - ind - plo + self_min) if rev \
            else (ind - plo + self_min)
    else:  # split normal to the patch: partner not split, only retagged
        cand_dir = self_surf.direction
        cand_ind = ind

    # when the split is normal to the partner patch, the patch lies wholly
    # in the lower or upper half; an 'upper' partner surface means the patch
    # ended up in the upper block
    use_upper = (d == part_surf.direction) and not part_surf.is_lower
    lo_s, up_s, split, low = surface_dependent_split(
        self_surf, cand_dir, cand_ind, sblk,
        ublk if use_upper else lblk, ublk, orientation)

    if split:
        surfs[idx] = lo_s
        surfs.insert(idx, up_s)
    elif low:
        surfs[idx] = lo_s
    else:
        surfs[idx] = up_s
    return _mk_bc(surfs)


# ---------------------------------------------------------------------------
# connection lookup for dependent splits


def block_inter_conns(bcs, grids, blk):
    """For each interblock surface of ``blk``: its partner surface and the
    orientation of the pair (reference: GetBlockInterConnBCs,
    boundaryConditions.cpp:606-652).  Keyed by position in the surface
    list (surfaces are not hashable-unique)."""
    out = {}
    for n, s in enumerate(bcs[blk].surfaces):
        if s.bc_type != "interblock":
            continue
        pb = partner_block(s)
        self_side = _patch_side(blk, s)
        for ps in bcs[pb].surfaces:
            if ps.bc_type != "interblock":
                continue
            if (partner_block(ps) == blk
                    and partner_surface(s) == surf_type(ps)
                    and partner_surface(ps) == surf_type(s)
                    and not (pb == blk and ps == s)):
                part_side = _patch_side(pb, ps)
                c_part = _patch_corners(grids[pb], part_side)
                c_self = _patch_corners(grids[blk], self_side)
                orient = match_orientation(c_part, c_self)
                if orient is not None:
                    out[n] = (ps, orient)
                    break
    return out


# ---------------------------------------------------------------------------
# the decomposition driver


@dataclasses.dataclass
class Decomposition:
    """Block -> device-slot map with split history
    (reference: parallel.hpp:46-135 decomposition)."""

    rank: list
    parent: list
    # (lower_blk, upper_blk, direction, index) per split
    splits: list
    nproc: int

    def num_cells(self, grids):
        return [int(np.prod([d - 1 for d in g.shape[:3]])) for g in grids]

    def loads(self, grids):
        load = [0] * self.nproc
        for b, c in enumerate(self.num_cells(grids)):
            load[self.rank[b]] += c
        return load


def _split_block(grids, bcs, decomp, blk, d, ind):
    """Split block ``blk`` at face ``ind`` along ``d``; the upper half is
    appended as a new block (reference: parallel.cpp:125-147)."""
    new_blk = len(grids)
    affected = block_inter_conns(bcs, grids, blk)

    ax = AX[d]
    nodes = grids[blk]
    sl_lo = [slice(None)] * nodes.ndim
    sl_lo[ax] = slice(0, ind + 1)
    sl_up = [slice(None)] * nodes.ndim
    sl_up[ax] = slice(ind, None)
    grids.append(np.ascontiguousarray(nodes[tuple(sl_up)]))
    grids[blk] = np.ascontiguousarray(nodes[tuple(sl_lo)])

    lower_bc, upper_bc, altered = bc_split(bcs[blk], d, ind, blk, new_blk)
    bcs[blk] = lower_bc
    bcs.append(upper_bc)

    for n, alt in altered:
        if n not in affected:
            raise ValueError(
                f"no matching partner for interblock surface {alt}")
        self_surf, orient = affected[n]
        pb = partner_block(alt)
        bcs[pb] = bc_dependent_split(bcs[pb], alt, self_surf, orient, pb,
                                     d, ind, blk, new_blk)

    decomp.splits.append((blk, new_blk, d, ind))
    decomp.rank.append(decomp.rank[blk])
    decomp.parent.append(decomp.parent[blk])


def _send_whole_or_split(grids, bcs, decomp, send, recv):
    """reference: decomposition::SendWholeOrSplit (parallel.cpp:641-720).
    Returns (blk, dir, ind) with ind < 0 meaning send the whole block."""
    cells = decomp.num_cells(grids)
    total = sum(cells)
    ideal = total / decomp.nproc
    loads = decomp.loads(grids)
    send_load, recv_load = loads[send], loads[recv]
    send_ratio = abs(1.0 - send_load / ideal)
    recv_ratio = abs(1.0 - recv_load / ideal)

    for b in range(len(grids)):
        if decomp.rank[b] != send:
            continue
        nsr = abs(1.0 - (send_load - cells[b]) / ideal)
        nrr = abs(1.0 - (recv_load + cells[b]) / ideal)
        if nsr < send_ratio and nrr < recv_ratio:
            return b, "none", -1

    # split the largest block on the sender
    blk = max((b for b in range(len(grids)) if decomp.rank[b] == send),
              key=lambda b: cells[b])
    sh = grids[blk].shape  # node counts
    if sh[2] >= sh[1] and sh[2] >= sh[0]:
        d = "k"
        plane = (sh[1] - 1) * (sh[0] - 1)
        split_len = sh[2]
    elif sh[1] >= sh[0]:
        d = "j"
        plane = (sh[2] - 1) * (sh[0] - 1)
        split_len = sh[1]
    else:
        d = "i"
        plane = (sh[1] - 1) * (sh[2] - 1)
        split_len = sh[0]

    ind = -1
    for ii in range(2, split_len - 2):
        nsr = abs(1.0 - (send_load - plane * ii) / ideal)
        nrr = abs(1.0 - (recv_load + plane * ii) / ideal)
        if nsr < send_ratio and nrr < recv_ratio:
            send_ratio, recv_ratio = nsr, nrr
            ind = ii
    return blk, d, ind


def cubic_decomposition(grids, bcs, nproc):
    """Greedy move-or-split load balancing (reference:
    parallel.cpp:95-178).  Mutates grids/bcs in place; returns the
    Decomposition (block -> slot map + split history)."""
    decomp = Decomposition(rank=[0] * len(grids),
                           parent=list(range(len(grids))),
                           splits=[], nproc=nproc)
    total = sum(decomp.num_cells(grids))
    ideal = total / nproc
    count = 0
    max_splits = nproc * 10
    while max(decomp.loads(grids)) / ideal > 1.1 and count < max_splits:
        loads = decomp.loads(grids)
        ol = int(np.argmax(loads))
        ul = int(np.argmin(loads))
        blk, d, ind = _send_whole_or_split(grids, bcs, decomp, ol, ul)
        if ind < 0 and d == "none":
            decomp.rank[blk] = ul
        else:
            _split_block(grids, bcs, decomp, blk, d, ind)
            decomp.rank[blk] = ul
        count += 1
    return decomp


def manual_decomposition(grids, bcs, nproc):
    """One block per device slot (reference: parallel.cpp:44-90)."""
    if len(grids) != nproc:
        raise ValueError(
            f"manual decomposition requires blocks == slots; "
            f"have {len(grids)} blocks, {nproc} slots")
    return Decomposition(rank=list(range(len(grids))),
                         parent=list(range(len(grids))),
                         splits=[], nproc=nproc)


def decompose(grids, bcs, nproc, method="cubic"):
    """Entry point: split (grids, bcs) for ``nproc`` device slots."""
    grids = list(grids)
    bcs = list(bcs)
    if method == "manual":
        decomp = manual_decomposition(grids, bcs, nproc)
    else:
        decomp = cubic_decomposition(grids, bcs, nproc)
    return grids, bcs, decomp


# ---------------------------------------------------------------------------
# cell-array recombination / re-splitting across the decomposition
# (reference: output.cpp:1089-1166 Recombine undoes splits for output;
# parallel.hpp:137-154 DecompArray re-applies them when reading restarts)


def join_cell_arrays(splits, arrs, axes=(1, 2, 3)):
    """Undo ``splits`` on per-block cell arrays: concatenation of each
    (lower, upper) pair along the split direction, processed in reverse
    split order (the upper half of the most recent split is always the
    highest live index).  ``axes`` maps (i, j, k) to array axes."""
    ax_of = dict(zip("ijk", axes))
    arrs = list(arrs)
    for lo, up, d, ind in reversed(splits):
        assert up == len(arrs) - 1, "split order violated"
        arrs[lo] = np.concatenate([arrs[lo], arrs[up]], axis=ax_of[d])
        arrs.pop()
    return arrs


def split_cell_arrays(splits, arrs, axes=(1, 2, 3)):
    """Re-apply ``splits`` to parent-structure cell arrays, reproducing
    the decomposed block ordering (lower keeps cells [0, ind), upper gets
    the rest, appended at the end exactly as _split_block did)."""
    ax_of = dict(zip("ijk", axes))
    arrs = list(arrs)
    for lo, up, d, ind in splits:
        ax = ax_of[d]
        nd = arrs[lo].ndim
        sl_lo = [slice(None)] * nd
        sl_lo[ax] = slice(0, ind)
        sl_up = [slice(None)] * nd
        sl_up[ax] = slice(ind, None)
        assert up == len(arrs)
        arrs.append(np.ascontiguousarray(arrs[lo][tuple(sl_up)]))
        arrs[lo] = np.ascontiguousarray(arrs[lo][tuple(sl_lo)])
    return arrs
