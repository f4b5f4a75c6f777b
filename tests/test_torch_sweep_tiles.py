"""PyTorch port, the CUDA sweeps' tile wavefront (csrc/sweep_wavefront.cuh)
on the CPU, with no kernel and no JAX: the host tile table
(``implicit.tile_table``) covers every cell once in a topological order,
and the kernels' schedule, emulated here on the plain per-cell math
(``implicit.offdiagonal`` and the plain sweep's update), gives the plain
plane-order sweep (``forward_plain`` / ``backward_plain``) bit for bit.

The emulation mirrors the kernel's control thread: a tile's sweep-local
plane q may run once each predecessor tile P_d (lower neighbour along d
forward, upper backward) has published min(q + e_Pd, planes of P_d)
planes.  It advances every tile whose predecessors allow it by one plane
a round, from the flags published before the round, so a rule that let a
tile read a cell in the round that writes it would show as a different
result.  The per-cell math
is elementwise, so the batching of cells (a plane, a tile's plane, a
round) does not change a bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aither_tpu_torch.cases import write_plate_case  # noqa: E402
from aither_tpu_torch.kernels import lusgs_sweep as ls  # noqa: E402
from aither_tpu_torch.solver import implicit as imp  # noqa: E402

TABLE_CASES = [((96, 120, 1), (16, 10, 1)), ((96, 120, 1), (8, 8, 1)),
               ((9, 7, 5), (16, 4, 5)), ((9, 7, 5), (4, 2, 3)),
               ((256, 64, 32), (16, 4, 5)), ((256, 64, 32), (8, 8, 4))]


@pytest.mark.parametrize("dims,tile", TABLE_CASES)
def test_tile_table_covers_every_cell_once(dims, tile):
    table = imp.tile_table(dims, tile)
    assert table.dtype == np.int32 and table.shape[1] == 6
    count = np.zeros(dims, dtype=np.int64)
    for oi, oj, ok, ei, ej, ek in table:
        assert 0 < ei <= tile[0] and 0 < ej <= tile[1] and 0 < ek <= tile[2]
        count[oi:oi + ei, oj:oj + ej, ok:ok + ek] += 1
    assert (count == 1).all()
    ragged = any(n % min(t, n) for n, t in zip(dims, tile))
    assert ragged == (table[:, 3:] != np.minimum(tile, dims)).any()


@pytest.mark.parametrize("dims,tile", TABLE_CASES)
@pytest.mark.parametrize("forward", [True, False])
def test_tile_table_is_topological(dims, tile, forward):
    """forward: a tile's lower neighbour tiles come before it in the table;
    backward (the table walked from its end): its upper ones"""
    table = imp.tile_table(dims, tile)
    rows = table if forward else table[::-1]
    rank = {tuple(r[:3]): n for n, r in enumerate(rows)}
    for n, r in enumerate(rows):
        for d in range(3):
            o = list(r[:3])
            o[d] += -tile[d] if forward else tile[d]
            if 0 <= o[d] < dims[d]:
                assert rank[tuple(o)] < n


def test_default_tiles():
    assert imp.sweep_tile((96, 120, 1)) == (32, 40, 1)
    assert imp.sweep_tile((256, 64, 32)) == (32, 4, 5)
    with pytest.raises(ValueError, match="80 \\(j, k\\) columns"):
        imp.tile_table((9, 7, 5), (8, 9, 9))


# ---------------------------------------------------------------------------
# the kernel's schedule


class Tiles:
    """the kernel's view of one sweep's tiles, in ticket order: per tile
    its predecessors (rows, -1 for none), their extents along d and plane
    counts, and each sweep-local plane's cells as physical flat indices"""

    def __init__(self, dims, tile, forward):
        table = imp.tile_table(dims, tile)
        self.rows = table if forward else table[::-1]
        t, n = np.asarray(tile), np.asarray(dims)
        tg = -(-n // t)
        tc = self.rows[:, :3] // t
        ids = (tc[:, 0] * tg[1] + tc[:, 1]) * tg[2] + tc[:, 2]
        row_of = np.full(int(np.prod(tg)), -1)
        row_of[ids] = np.arange(len(ids))
        e = self.rows[:, 3:]
        self.nq = e.sum(axis=1) - 2
        self.pred = np.full((len(ids), 3), -1)
        self.ext = np.zeros((len(ids), 3), dtype=np.int64)
        for d in range(3):
            pc = tc.copy()
            pc[:, d] += -1 if forward else 1
            ok = (pc[:, d] >= 0) & (pc[:, d] < tg[d])
            pid = (pc[:, 0] * tg[1] + pc[:, 1]) * tg[2] + pc[:, 2]
            self.pred[ok, d] = row_of[pid[ok]]
            self.ext[:, d] = np.minimum(t[d], n[d] - pc[:, d] * t[d])
        self.pnq = self.nq[:, None] - e + self.ext
        self.planes = []
        for (oi, oj, ok_, ei, ej, ek) in self.rows:
            a, b, c = (x.ravel() for x in np.meshgrid(
                np.arange(ei), np.arange(ej), np.arange(ek), indexing="ij"))
            q = (a + b + c if forward
                 else (ei - 1 - a) + (ej - 1 - b) + (ek - 1 - c))
            flat = ((oi + a) * dims[1] + (oj + b)) * dims[2] + (ok_ + c)
            self.planes.append([flat[q == p] for p in range(ei + ej + ek - 2)])

    def rounds(self):
        """[[(row, plane), ...] per round]: every tile whose predecessors'
        flags, as published before the round, allow its next plane does
        it; a tile publishes after each plane"""
        done = np.zeros(len(self.rows), dtype=np.int64)
        out = []
        while (done < self.nq).any():
            need = np.minimum(done[:, None] + self.ext, self.pnq)
            have = np.where(self.pred >= 0, done[self.pred], 0)
            ok = ((self.pred < 0) | (have >= need)).all(axis=1)
            go = np.flatnonzero(ok & (done < self.nq))
            assert go.size, "the schedule stalled"
            out.append([(int(r), int(done[r])) for r in go])
            done[go] += 1
        return out


@pytest.mark.parametrize("dims,tile", TABLE_CASES)
@pytest.mark.parametrize("forward", [True, False])
def test_critical_path(dims, tile, forward):
    """the wavefront takes the block's ni+nj+nk-2 planes, one a round,
    and every tile does each of its planes once"""
    tiles = Tiles(dims, tile, forward)
    rounds = tiles.rounds()
    assert len(rounds) == sum(dims) - 2
    done = sorted(step for r in rounds for step in r)
    assert done == [(r, q) for r in range(len(tiles.rows))
                    for q in range(tiles.nq[r])]


# ---------------------------------------------------------------------------
# the schedule on the plain per-cell math


# the fixture's decks: scalar and block SST at two ghost layers, and the
# scalar one with WENO-Z's three
SYSTEMS = {"lusgs": dict(matrix_solver="lusgs"),
           "blusgs": dict(matrix_solver="blusgs"),
           "lusgs_g3": dict(matrix_solver="lusgs",
                            face_reconstruction="wenoZ")}


@pytest.fixture(scope="module", params=list(SYSTEMS))
def system(request, tmp_path_factory):
    """(solver, per block: prim, aux, b, inverses, a seeded du0 with random
    ghosts, the lagged terms of both sweeps) of the 1%-perturbed SST plate
    of 2 x 9x7x5 cells on the CPU"""
    from aither_tpu_torch.solver.driver import Solver
    wd = str(tmp_path_factory.mktemp("tiles"))
    path = write_plate_case(wd, 9, 7, 5, **SYSTEMS[request.param])
    s = Solver(path, device="cpu", workdir=wd)
    assert s.case.blocks[0].g == (3 if request.param == "lusgs_g3" else 2)
    rng = np.random.default_rng(11)
    prims = {}
    for b in s.case.blocks:
        prim = b.prim0.numpy().copy()
        prim[b.interior] *= 1.0 + 0.01 * rng.random(prim[b.interior].shape)
        prims[b.index] = prim
    s.set_state(prims)
    prims, res, sr, dg, dts, auxs = s._residuals(dict(s.prims),
                                                 s.deck.cfl(0))
    inv_diag, _, bs, _ = s._setup_linear(prims, res, sr, dg, dts, auxs,
                                         s.cons_n)
    out = {}
    for b in s.case.blocks:
        bi = b.index
        du0 = torch.as_tensor(1e-4 * rng.standard_normal(
            (s.phys.neq,) + b.shape))
        extras = tuple(imp.offdiag_sum(s.phys, s.cfg, b, prims[bi], du0,
                                       side, auxs[bi])
                       for side in ("upper", "lower"))
        out[bi] = (prims[bi], auxs[bi], bs[bi], inv_diag[bi], du0, extras)
    return s, out


def update_cells(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, forward,
                 extra, sel):
    """the plain sweep's update of the cells at plane-ordered positions
    ``sel`` (kernels/lusgs_sweep.py _plain_sweep, one batch)"""
    side = "lower" if forward else "upper"
    blk = bool(cfg.get("block_matrix"))
    C = prim.shape[0]
    qf, duf = prim.reshape(C, -1), du.view(C, -1)
    viscous = bool(cfg.get("viscous"))
    bf = b.reshape(C, -1)
    ef = extra.reshape(C, -1) if extra is not None else None
    if blk:
        invf = inv_f.reshape(inv_f.shape[0], -1)
        invt = None if inv_t is None else inv_t.reshape(4, -1)
        dmul = imp.diag_mult_channels
    else:
        invf = inv_f.reshape(-1)
        invt = None if inv_t is None else inv_t.reshape(-1)
        dmul = imp.diag_mult
    sign = -1 if forward else 1
    n = len(sel)
    cells, pcells = plan.cells[sel], plan.phys_cells[sel]
    nb = torch.cat([cells + sign * plan.strides[d] for d in range(3)])
    stat = plan.static[side][pcells].transpose(0, 1).reshape(3 * n, -1)
    kw = {}
    if viscous:
        kw = dict(dist=stat[:, 4], mu=aux["mu"].reshape(-1)[nb],
                  mut=aux["mut"].reshape(-1)[nb],
                  f1=aux["f1"].reshape(-1)[nb])
        if blk:
            kw["vgrad"] = aux["vgrad"].reshape(9, -1)[:, nb].reshape(3, 3,
                                                                     -1)
    contrib = imp.offdiagonal(phys, cfg, qf[:, nb], duf[:, nb],
                              stat[:, 0:3].T, stat[:, 3], forward, **kw)
    mask = plan.mask[side][pcells]
    acc = 0.0
    for d in range(3):
        acc = acc + torch.where(mask[:, d][None],
                                contrib[:, d * n:(d + 1) * n], 0.0)
    inv = (invf[..., pcells], None if invt is None else invt[..., pcells])
    if forward:
        rhs = bf[:, pcells] + acc
        if ef is not None:
            rhs = rhs - ef[:, pcells]
        duf[:, cells] = dmul(phys, *inv, rhs)
    elif ef is not None:
        duf[:, cells] = dmul(phys, *inv, bf[:, pcells] + ef[:, pcells] - acc)
    else:
        duf[:, cells] = duf[:, cells] - dmul(phys, *inv, acc)


def emulate(solver, bi, inputs, forward, with_extra, tile, walk):
    """one sweep of block ``bi`` from inputs' du0 (or, backward, from the
    plain forward sweep's result) in the kernel's tile order: ``walk``
    "tiles" runs each tile whole, plane by plane, in ticket order;
    "rounds" runs the rounds of Tiles.rounds"""
    prim, aux, b, inv, du0, extras = inputs
    plan = solver.plans[bi]
    extra = extras[0 if forward else 1] if with_extra else None
    args = (solver.phys, solver.cfg, plan, prim)
    du = du0.clone()
    if not forward:
        ls.forward_plain(*args, du, b, *inv, aux,
                         extra=extras[0] if with_extra else None)
    start = du.clone()
    pos = torch.empty_like(plan.phys_cells)
    pos[plan.phys_cells] = torch.arange(len(pos))
    tiles = Tiles(plan.dims, tile, forward)
    if walk == "tiles":
        batches = [[(r, q)] for r in range(len(tiles.rows))
                   for q in range(tiles.nq[r])]
    else:
        batches = tiles.rounds()
    for batch in batches:
        flat = np.concatenate([tiles.planes[r][q] for r, q in batch])
        update_cells(*args, du, b, *inv, aux, forward, extra,
                     pos[torch.as_tensor(flat)])
    return start, du


@pytest.mark.parametrize("tile", [(16, 4, 5), (4, 2, 3)])
@pytest.mark.parametrize("walk", ["tiles", "rounds"])
@pytest.mark.parametrize("with_extra", [False, True])
def test_tile_order_sweep_is_the_plane_sweep(system, tile, walk,
                                             with_extra):
    """scalar and block forms (the fixture's lusgs and blusgs plates), with
    and without the lagged term, forward and backward: bit for bit"""
    solver, inputs = system
    for bi, inp in inputs.items():
        prim, aux, b, inv, _, extras = inp
        for forward in (True, False):
            start, got = emulate(solver, bi, inp, forward, with_extra, tile,
                                 walk)
            sweep = ls.forward_plain if forward else ls.backward_plain
            want = sweep(solver.phys, solver.cfg, solver.plans[bi], prim,
                         start.clone(), b, *inv, aux,
                         extra=extras[0 if forward else 1] if with_extra
                         else None)
            assert torch.equal(got, want), (bi, forward)


def test_tile_order_sweep_on_a_flat_block(tmp_path):
    """case A's 96x120x1 block in 20x16x1 tiles (ragged in i and j),
    scalar SST without the lagged term, through the rounds"""
    from aither_tpu_torch.solver.driver import Solver
    path = write_plate_case(str(tmp_path), 96, 120, 1)
    s = Solver(path, device="cpu", workdir=str(tmp_path))
    prims, res, sr, dg, dts, auxs = s._residuals(dict(s.prims),
                                                 s.deck.cfl(0))
    inv_diag, _, bs, _ = s._setup_linear(prims, res, sr, dg, dts, auxs,
                                         s.cons_n)
    b = s.case.blocks[1]
    du0 = torch.as_tensor(1e-4 * np.random.default_rng(2).standard_normal(
        (s.phys.neq,) + b.shape))
    inp = (prims[1], auxs[1], bs[1], inv_diag[1], du0, (None, None))
    for forward in (True, False):
        start, got = emulate(s, 1, inp, forward, False, (20, 16, 1),
                             "rounds")
        sweep = ls.forward_plain if forward else ls.backward_plain
        want = sweep(s.phys, s.cfg, s.plans[1], prims[1], start.clone(),
                     bs[1], *inv_diag[1], auxs[1])
        assert torch.equal(got, want)


def _gathered_statics(block, side):
    """(statics, masks) of one sweep side gathered cell by cell, in
    physical order: the plan's definition (``implicit.SweepPlan``) by
    fancy indexing of the padded geometry"""
    ni, nj, nk, g = block.ni, block.nj, block.nk, block.g
    ii, jj, kk = (a.ravel() for a in np.meshgrid(
        np.arange(ni), np.arange(nj), np.arange(nk), indexing="ij"))
    pc = [ii + g, jj + g, kk + g]
    off, fo = (-1, 0) if side == "lower" else (1, 1)
    center = block.geom_host["center"]
    masks = imp.neighbor_masks(block, side)
    stat = np.zeros((len(ii), 3, len(imp.STATIC_CHANNELS)))
    msk = np.zeros((len(ii), 3), dtype=bool)
    for a, d in enumerate("ijk"):
        nb, face = list(pc), list(pc)
        nb[a] = nb[a] + off
        face[a] = face[a] + fo
        nvec = block.geom_host[f"n_{d}"][:, face[0], face[1], face[2]]
        c2c = center[:, pc[0], pc[1], pc[2]] - center[:, nb[0], nb[1], nb[2]]
        stat[:, a, 0:3] = nvec.T
        stat[:, a, 3] = block.geom_host[f"mag_{d}"][face[0], face[1],
                                                    face[2]]
        stat[:, a, 4] = np.abs((c2c * nvec).sum(axis=0))
        msk[:, a] = masks[d][ii, jj, kk]
    return stat, msk


@pytest.mark.parametrize("nproc,deck", [
    (1, {}), (1, dict(face_reconstruction="wenoZ")), (4, {})])
def test_plan_statics_are_the_gathered_ones(tmp_path, nproc, deck):
    """every block's plan statics and masks, built from slices, equal the
    cell-by-cell gathers bit for bit (two and three ghost layers; a
    decomposition whose connection ghosts contribute)"""
    from aither_tpu_torch.solver.driver import Solver
    path = write_plate_case(str(tmp_path), 16, 8, 4, **deck)
    s = Solver(path, device="cpu", workdir=str(tmp_path), nproc=nproc)
    assert len(s.case.blocks) == max(nproc, 2)
    for b in s.case.blocks:
        for side in ("lower", "upper"):
            stat, msk = _gathered_statics(b, side)
            assert torch.equal(s.plans[b.index].static[side],
                               torch.as_tensor(stat)), (b.index, side)
            assert torch.equal(s.plans[b.index].mask[side],
                               torch.as_tensor(msk)), (b.index, side)


def test_library_name_hashes_the_shared_header(tmp_path, monkeypatch):
    """an edited csrc header renames (so rebuilds) the sweep libraries
    that include it, Rusanov, Roe and thermally perfect builds alike, and
    no other; a Roe or thermally perfect build is another library of the
    same source"""
    import shutil
    from aither_tpu_torch.utils import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    sweeps = ("lusgs_sweep", "blusgs_sweep", "lusgs_sweep_roe",
              "blusgs_sweep_roe", "lusgs_sweep_tp", "blusgs_sweep_tp")
    names = sweeps + ("viscous_march",)
    assert [h.rsplit("/", 1)[-1] for h in build.local_headers(
        str(csrc / "lusgs_sweep.cu"))] == ["roe_offdiag.cuh",
                                           "sweep_wavefront.cuh",
                                           "thermo_tp.cuh",
                                           "tp_state.cuh"]
    for header in ("sweep_wavefront.cuh", "roe_offdiag.cuh",
                   "thermo_tp.cuh", "tp_state.cuh"):
        before = {n: build._paths(n) for n in names}
        for variant, define in (("roe", "-DSWEEP_ROE=1"),
                                ("tp", "-DSWEEP_TP=1")):
            assert (before[f"lusgs_sweep_{variant}"][0]
                    == before["lusgs_sweep"][0])
            assert (before[f"lusgs_sweep_{variant}"][1]
                    != before["lusgs_sweep"][1])
            assert define in before[f"blusgs_sweep_{variant}"][2]
        with open(csrc / header, "a") as f:
            f.write("// edited\n")
        after = {n: build._paths(n) for n in names}
        for n in sweeps:
            assert after[n][1] != before[n][1], (header, n)
        assert after["viscous_march"] == before["viscous_march"]
