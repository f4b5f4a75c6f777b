"""PyTorch port, the scalar sweeps' decomposition (``csrc/lusgs_sweep.cu``,
every form of its Rusanov and thermally perfect builds), held on the CPU
in plain PyTorch, without JAX:

1. a plain twin of the kernel's pre-pass (per unmasked face of a sweep
   side the old flux F(q_nb).n, or F_roe(q_nb | q_cell) for approximateRoe,
   and the face radii; for a thermally perfect gas per cell its old
   specific total energy) and of the neighbour's q + du (a thermally
   perfect form's stage: q + du from that energy, inverted once per cell;
   a calorically perfect lane's closed form): the product assembled from
   those stored terms and the new flux of q + du equals
   ``implicit.offdiagonal`` per cell and direction bit for bit
   (``torch.equal``), forward and backward, on a small generated plate,
   for the calorically perfect Rusanov decks (one-species SST, the main
   path, Euler, laminar, Wilcox, N2/O2 and seven-species hydrogen-air),
   for hot air, N2/O2 and seven-species hydrogen-air thermally perfect and
   hot air thermally perfect approximateRoe;
2. a plain twin of the stage's inversion (``thermo_tp.cuh``
   temperature_from_energy_spec: f4 and the three midpoints the next
   bracket can have evaluated together) gives the Physics' Ridder T bit
   for bit;
3. ``sweep_cost`` of the redesigned forms at case-A and case-B sized
   plans: one inversion of q + du per updated state, and the pre-pass's
   bytes; the calorically perfect Rusanov forms' work space and pre-pass
   bytes, scalar and block; and the persistent CTAs of the wavefront
   (``implicit.wavefront_ctas``).

The plain functions themselves are held to the JAX package by
``test_torch_physics5b_tp*.py`` and ``test_torch_species7.py``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aither_tpu_torch.cases import (MIXTURES, SMOKE_2D_DIMS,  # noqa: E402
                                    SMOKE_3D_DIMS, TP_AIR, write_plate_case)
from aither_tpu_torch.kernels import lusgs_sweep as ls  # noqa: E402
from aither_tpu_torch.physics.models import (RIDDER_HI,  # noqa: E402
                                             RIDDER_ITERS, RIDDER_LO,
                                             RIDDER_TOL)
from aither_tpu_torch.solver import implicit as imp  # noqa: E402
from aither_tpu_torch.solver import state as st  # noqa: E402
from aither_tpu_torch.solver.driver import Solver  # noqa: E402
from aither_tpu_torch.solver.flux import (physical_flux,  # noqa: E402
                                          roe_flux)

DIMS = (6, 5, 3)
TP_GAS = dict(thermodynamic_model="thermallyPerfect")
ROE = dict(inviscid_flux_jacobian="approximateRoe")
TP_DECKS = {"hot_air": TP_AIR,
            "n2o2": dict(MIXTURES["n2o2"], **TP_GAS),
            "h2air7": dict(MIXTURES["h2air7_frozen"], **TP_GAS),
            "hot_air_roe": dict(TP_AIR, **ROE)}
# the calorically perfect Rusanov decks (one-species SST: the main path)
CP_DECKS = {"sst": {},
            "euler": dict(equation_set="euler", turbulence_model="none"),
            "laminar": dict(equation_set="navierStokes",
                            turbulence_model="none"),
            "wilcox": dict(turbulence_model="kOmegaWilcox2006"),
            "n2o2_cp": MIXTURES["n2o2"],
            "h2air7_frozen": MIXTURES["h2air7_frozen"]}
DECKS = {**TP_DECKS, **CP_DECKS}
_SYSTEMS = {}


def build_system(name, tmp_path_factory):
    """a deck's Solver on the CPU, its first residual's state and aux
    fields (ghosts filled) and a seeded du of 1e-3 of each equation's
    scale on every padded cell; built once a deck for the module's
    fixtures"""
    if name in _SYSTEMS:
        return _SYSTEMS[name]
    wd = str(tmp_path_factory.mktemp(name))
    s = Solver(write_plate_case(wd, *DIMS, **DECKS[name]), device="cpu",
               workdir=wd)
    prims, _, _, _, _, auxs = s._residuals(dict(s.prims), s.deck.cfl(0))
    rng = np.random.default_rng(5)
    dus = {}
    for bi, q in prims.items():
        scale = q.abs().amax(dim=(1, 2, 3), keepdim=True)
        dus[bi] = 1e-3 * scale * torch.as_tensor(
            rng.uniform(-1.0, 1.0, tuple(q.shape)))
    _SYSTEMS[name] = (s, prims, auxs, dus)
    return _SYSTEMS[name]


@pytest.fixture(scope="module", params=sorted(DECKS))
def system(request, tmp_path_factory):
    return build_system(request.param, tmp_path_factory)


@pytest.fixture(scope="module", params=sorted(TP_DECKS))
def tp_system(request, tmp_path_factory):
    return build_system(request.param, tmp_path_factory)


# ---------------------------------------------------------------------------
# the kernel's decomposition in plain PyTorch


def old_terms(phys, cfg, q_nb, q_cell, n, mag, positive, dist, mu, mut, f1):
    """the pre-pass of one batch of faces: (old flux, sr, sr_t), the
    radii None where the form has none"""
    viscous = cfg.get("viscous", False)
    turb = viscous and phys.nturb
    if cfg.get("inv_flux_jac") == "approximateRoe":
        old = roe_flux(phys, q_nb, q_cell, n)
        sr = (imp.viscous_face_spectral_radius(phys, q_nb, mag, dist, mu,
                                               mut) if viscous else None)
        sr_t = (imp._turb_viscous_face_sr(phys, cfg, q_nb, mag, dist, mu,
                                          mut, f1) if turb else None)
        return old, sr, sr_t
    old = physical_flux(phys, q_nb, n)
    sr = imp.face_spectral_radius(phys, q_nb, n, mag, dist, mu, mut,
                                  viscous)
    sr_t = None
    if phys.nturb:
        vn = (st.velocity(phys, q_nb) * n).sum(dim=0)
        sr_t = (0.5 * mag * torch.abs(vn + torch.abs(vn)) if positive
                else 0.5 * mag * torch.abs(vn - torch.abs(vn)))
        if turb:
            sr_t = sr_t + imp._turb_viscous_face_sr(phys, cfg, q_nb, mag,
                                                    dist, mu, mut, f1)
    return old, sr, sr_t


def old_energy(phys, q):
    """a state's specific total energy, as the pre-pass stores it"""
    vel = st.velocity(phys, q)
    e = phys.mix(phys.species_energy(st.temperature(phys, q)),
                 st.mixture_fractions(phys, q))
    return e + 0.5 * (vel * vel).sum(dim=0)


def stage(phys, q, du, e_old):
    """q + du from the stored old energy, inverted once (the kernel's
    update_prim_mix_from)"""
    r = st.rho(phys, q)
    parts = [q[:phys.ns], r[None] * st.velocity(phys, q),
             (r * e_old)[None]]
    if phys.nturb:
        parts.append(r[None] * q[phys.it:])
    cons = torch.cat(parts, dim=0) + du
    rs = cons[:phys.ns].sum(dim=0)
    mf = torch.clamp(cons[:phys.ns] / rs[None], min=0.0)
    mf = mf / mf.sum(dim=0)[None]
    cons = torch.cat([rs[None] * mf, cons[phys.ns:]], dim=0)
    return st.prim_from_cons(phys, cons)


def stored_product(phys, cfg, qu, du, q_cell, n, mag, positive, old, sr,
                   sr_t):
    """a neighbour's product from the stored terms and the new flux of its
    q + du"""
    if cfg.get("inv_flux_jac") == "approximateRoe":
        new = (roe_flux(phys, qu, q_cell, n) if positive
               else roe_flux(phys, q_cell, qu, n))
        dflux = mag[None] * (new - old)
        if sr is None:
            return dflux
        term = sr[None] * du
    else:
        dflux = 0.5 * mag[None] * (physical_flux(phys, qu, n) - old)
        term = sr[None] * du
    if sr_t is not None:
        if cfg.get("inv_flux_jac") != "approximateRoe":
            dflux = torch.cat([dflux[:phys.it],
                               torch.zeros_like(dflux[phys.it:])])
        term = torch.cat([term[:phys.it], sr_t[None] * du[phys.it:]])
    return dflux + term if positive else dflux - term


@pytest.mark.parametrize("forward", [True, False])
def test_stored_terms_product_is_the_offdiagonal(system, forward):
    s, prims, auxs, dus = system
    phys, cfg = s.phys, s.cfg
    tp = ls.sweep_form(phys, cfg)[5]
    assert ls.prepass_form(ls.sweep_form(phys, cfg))
    side = "lower" if forward else "upper"
    sign = -1 if forward else 1
    for bi, plan in s.plans.items():
        C = prims[bi].shape[0]
        qf, duf = prims[bi].reshape(C, -1), dus[bi].reshape(C, -1)
        # Euler has no viscous fields
        aux = {k: (None if auxs[bi] is None else auxs[bi][k].reshape(-1))
               for k in ("mu", "mut", "f1")}
        cells, pcells = plan.cells, plan.phys_cells
        mask = plan.mask[side][pcells]
        compared = 0
        for d in range(3):
            m = mask[:, d]
            cell, nb = cells[m], cells[m] + sign * plan.strides[d]
            stat = plan.static[side][pcells[m], d]
            n, mag, dist = stat[:, 0:3].T, stat[:, 3], stat[:, 4]
            kw = {k: None if v is None else v[nb] for k, v in aux.items()}
            kw["dist"] = dist
            # the neighbours' q + du (thermally perfect: from their stored
            # old energies, the stage's, a ghost's the pre-pass's;
            # calorically perfect: the lane's closed form) and the old
            # terms.  Each is evaluated on this batch of faces: the plain
            # species sums (torch's vectorised reductions over a tensor's
            # first axis) round by the position of a cell in its batch
            # from about 7 species on, so only the same batch compares bit
            # for bit
            if tp:
                qu = stage(phys, qf[:, nb], duf[:, nb],
                           old_energy(phys, qf[:, nb]))
            else:
                qu = st.update_prim_with_cons(phys, qf[:, nb], duf[:, nb])
            old, sr, sr_t = old_terms(phys, cfg, qf[:, nb], qf[:, cell], n,
                                      mag, forward, **kw)
            got = stored_product(phys, cfg, qu, duf[:, nb], qf[:, cell], n,
                                 mag, forward, old, sr, sr_t)
            want = imp.offdiagonal(phys, cfg, qf[:, nb], duf[:, nb], n, mag,
                                   forward, q_diag=qf[:, cell], **kw)
            assert bool(torch.isfinite(want).all())
            assert torch.equal(got, want), (bi, d)
            compared += int(m.sum())
        assert compared > 0


def group_inversion(phys, e, mf):
    """a plain twin of the stage's inversion (csrc/thermo_tp.cuh
    temperature_from_energy_spec): each iteration evaluates f4 at x4 and
    the three midpoints the next bracket can have at once, and takes the
    next f3 from the one its bracket has, where Ridder's method evaluates
    that midpoint at the next iteration's start"""
    def res(x):
        return e - phys.mix(phys.species_energy(x), mf)

    x1 = torch.full_like(e, RIDDER_LO)
    x2 = torch.full_like(e, RIDDER_HI)
    f1, f2, f3 = res(x1), res(x2), res(0.5 * (x1 + x2))
    bracketed = torch.sign(f1) != torch.sign(f2)
    x4 = torch.full_like(e, RIDDER_HI)
    done = ~bracketed
    for _ in range(RIDDER_ITERS):
        if bool(done.all()):
            break
        x3 = 0.5 * (x1 + x2)
        denom = torch.sqrt(torch.abs(f3 * f3 - f1 * f2)) + 1.0e-300
        x4n = x3 + (x3 - x1) * (torch.sign(f1 - f2) * f3) / denom
        f4, g1, g2, g3 = (res(x4n), res(0.5 * (x3 + x4n)),
                          res(0.5 * (x1 + x4n)), res(0.5 * (x4n + x2)))
        x4 = torch.where(done, x4, x4n)
        c1 = torch.sign(f4) != torch.sign(f3)
        c2 = torch.sign(f4) != torch.sign(f1)
        nx1 = torch.where(c1, x3, torch.where(c2, x1, x4n))
        nf1 = torch.where(c1, f3, torch.where(c2, f1, f4))
        nx2 = torch.where(c1, x4n, torch.where(c2, x4n, x2))
        nf2 = torch.where(c1, f4, torch.where(c2, f4, f2))
        nf3 = torch.where(c1, g1, torch.where(c2, g2, g3))
        stop = (torch.abs(nx2 - nx1) <= RIDDER_TOL) | (f3 == 0.0) | (f4 == 0.0)
        x1, f1 = torch.where(done, x1, nx1), torch.where(done, f1, nf1)
        x2, f2 = torch.where(done, x2, nx2), torch.where(done, f2, nf2)
        f3 = torch.where(done, f3, nf3)
        done = done | stop
    return torch.where(bracketed, x4, RIDDER_HI)


def test_group_inversion_is_the_physics(tp_system):
    """the stage's inversion of q + du (evaluating the next iteration's
    midpoint beside x4) takes the same points as Ridder's method, so it
    gives the Physics' T bit for bit: on every padded cell's q + du, and
    on the energies of the first cell's mixture from 50 to 20,000 K, whose
    brackets take all three of Ridder's branches (the plate's states take
    the first one only)"""
    s, prims, _, dus = tp_system
    phys = s.phys
    for bi, q in prims.items():
        cons = st.cons_from_prim(phys, q) + dus[bi]
        r = cons[:phys.ns].sum(dim=0)
        vel = cons[phys.mx:phys.mx + 3] / r[None]
        e = cons[phys.ie] / r - 0.5 * (vel * vel).sum(dim=0)
        mf = st.mixture_fractions(phys, cons)
        want, iters = phys._ridder_temperature(e, mf, count=True)
        assert float(iters.min()) > 2
        assert torch.equal(group_inversion(phys, e, mf), want)
    t = torch.linspace(50.0, 20000.0, 4001, dtype=torch.float64) / phys.t_ref
    if mf is not None:
        mf = mf.reshape(phys.ns, -1)[:, :1].expand(-1, t.numel()).clone()
    e = phys.mix(phys.species_energy(t), mf)
    assert torch.equal(group_inversion(phys, e, mf),
                       phys._ridder_temperature(e, mf)[0])


# ---------------------------------------------------------------------------
# the bound of the redesigned forms


def box_plan(ni, nj, nk, g=2):
    """the statics-free part of a SweepPlan of one ni x nj x nk block
    whose every boundary face is masked: what ``sweep_cost`` reads"""
    NJ, NK = nj + 2 * g, nk + 2 * g
    i, j, k = torch.meshgrid(torch.arange(ni), torch.arange(nj),
                             torch.arange(nk), indexing="ij")
    idx = [a.reshape(-1) for a in (i, j, k)]
    cells = ((idx[0] + g) * NJ + idx[1] + g) * NK + idx[2] + g
    dims = (ni, nj, nk)
    return types.SimpleNamespace(
        cells=cells, phys_cells=torch.arange(cells.numel()),
        strides=(NJ * NK, NK, 1),
        mask={"lower": torch.stack([a > 0 for a in idx], dim=1),
              "upper": torch.stack([a < n - 1 for a, n in zip(idx, dims)],
                                   dim=1)},
        static={"lower": torch.empty(0, 3, 5), "upper": torch.empty(0, 3, 5)})


@pytest.mark.parametrize("dims", [SMOKE_2D_DIMS, SMOKE_3D_DIMS],
                         ids=["case_A", "case_B"])
@pytest.mark.parametrize("roe", [False, True])
def test_cost_counts_one_inversion_per_state_and_the_prepass(dims, roe):
    """the redesigned scalar forms invert q + du once per updated state
    (the block's distinct neighbours: every cell but the last of the
    sweep) and their bound moves the function's bytes, their pre-pass's
    terms counted apart (``prepass_bytes``; a calorically perfect form's
    pre-pass stores its face terms alone, ``test_torch_sweep_split_roe.py``
    and ``test_rusanov_work_space_and_cost``); the block Roe form inverts
    once per updated state too and adds no bytes (at case A)"""
    plan = box_plan(*dims)
    ncell = int(plan.cells.numel())
    ni, nj, nk = dims
    nfaces = ((ni - 1) * nj * nk + ni * (nj - 1) * nk + ni * nj * (nk - 1))
    # both sweeps at case A; the forward one of the 1.05M cells of case B
    # (each count there is a unique of 1.5M neighbour indices)
    for forward in (True, False)[:1 if ncell > 10 ** 5 else 2]:
        nread, nghost = ls.neighbour_reads(plan, forward)
        assert (nread, nghost) == (ncell - 1, 0)
        form = ls.SST_FORM[:4] + (roe, True)
        caloric = ls.sweep_cost(plan, forward, False, False,
                                form[:5] + (False,))
        costs = [ls.sweep_cost(plan, forward, False, False, form,
                               modes=(1,), ridder_iters=it)
                 for it in (5.0, 10.0)]
        # 10 more energy evaluations of 4 + 5 operations, 5 brackets of 19
        assert costs[1][1] - costs[0][1] == (10 * 9 + 5 * 19) * nread
        nv = 9 if roe else 7
        assert ls.face_values(form) == nv
        # the function's bytes only; the work space's traffic beside them
        assert costs[0][0] == caloric[0]
        assert ls.prepass_bytes(plan, forward, form) == 8 * 2 * (
            nv * nfaces + ncell + 7 * nread)
        assert ls.prepass_bytes(plan, forward, form[:5] + (False,)) == (
            8 * 2 * nv * nfaces)
        # per face the fluxes' thermodynamics, per state q + du
        per_nb = ((ls.roe_mixture_neighbour_ops(form)
                   + ls.tp_roe_extra_ops(form, (1,))) if roe
                  else (ls.mixture_neighbour_ops(form, False, False)
                        + ls.tp_extra_ops(form, (1,), False, False)))
        per_state = ls.state_ops(form) + ls.tp_state_ops(form, (1,), 5.0)
        assert costs[0][1] == ((per_nb - ls.state_ops(form)) * nfaces
                               + per_state * nread + 2 * 7 * ncell)
        if roe and ncell < 10 ** 5:
            block = [ls.sweep_cost(plan, forward, False, True, form,
                                   modes=(1,), ridder_iters=it)
                     for it in (5.0, 10.0)]
            assert block[0][0] == ls.sweep_cost(plan, forward, False, True,
                                                form[:5] + (False,))[0]
            assert block[1][1] - block[0][1] == (10 * 9 + 5 * 19) * nread


@pytest.mark.parametrize("dims", [SMOKE_2D_DIMS, SMOKE_3D_DIMS],
                         ids=["case_A", "case_B"])
@pytest.mark.parametrize("block", [False, True])
def test_rusanov_work_space_and_cost(dims, block):
    """the calorically perfect Rusanov forms: the scalar ones store per
    face of the sweep side the flow rows of the old flux, the face radius
    and with turbulence equations the turbulence radius
    (``face_values``), each written and read once (``prepass_bytes``);
    the viscous block ones store per padded cell their neighbour state's
    conductivity (``cell_values``), written per physical cell and ghost
    read and read per unmasked face, the inviscid block ones nothing.
    Their bound stays the function's: ``sweep_cost`` counts the old-state
    terms per contributing face and no byte of the work space"""
    plan = box_plan(*dims)
    g = 2
    plan.padded = tuple(n + 2 * g for n in dims)
    plan.dims = dims
    ni, nj, nk = dims
    ncp = ni * nj * nk
    nc = (ni + 2 * g) * (nj + 2 * g) * (nk + 2 * g)
    nfaces = ((ni - 1) * nj * nk + ni * (nj - 1) * nk + ni * nj * (nk - 1))
    forward = True
    # (form, face values of the scalar form) of SST, Euler, laminar,
    # Wilcox, N2/O2 SST and seven-species SST
    forms = [((1, 7, True, False, False, False), 7),
             ((1, 5, False, False, False, False), 6),
             ((1, 5, True, False, False, False), 6),
             ((1, 7, True, True, False, False), 7),
             ((2, 8, True, False, False, False), 8),
             ((7, 13, True, False, False, False), 13)]
    if dims == SMOKE_3D_DIMS:
        forms = forms[:1]   # each count there is a unique of 1.5M indices
    nread, nghost = ls.neighbour_reads(plan, forward)
    for form, nv in forms:
        viscous = form[2]
        assert ls.prepass_form(form, block) == (not block or viscous)
        assert not ls.staged_form(form, block)
        if block:
            assert ls.cell_values(form) == 1
            assert ls.cell_terms_read(form, False) == 1
            assert ls.work_doubles(form, plan, True) == (nc if viscous
                                                         else 0)
            assert ls.prepass_bytes(plan, forward, form, True) == (
                8 * (ncp + nghost + nfaces) if viscous else 0)
        else:
            assert ls.face_values(form) == nv
            assert ls.work_doubles(form, plan) == nv * 3 * ncp
            assert ls.prepass_bytes(plan, forward, form) == (
                8 * 2 * nv * nfaces)
        nbytes, ops = ls.sweep_cost(plan, forward, False, block, form)
        N = form[0] + 4
        turb = form[1] == N + 2
        if form[0] == 1:
            per_nb = (ls.BLOCK_NEIGHBOUR_OPS_BY_FORM if block
                      else ls.NEIGHBOUR_OPS_BY_FORM)[form[1:4]]
        else:
            per_nb = ls.mixture_neighbour_ops(form, block, False)
        per_cell = (2 * N * N + N + (8 if turb else 0) if block
                    else 2 * form[1])
        assert ops == per_nb * nfaces + per_cell * ncp
        # the function's bytes: those of its thermally perfect twin, which
        # reads the same inputs
        assert nbytes == ls.sweep_cost(plan, forward, False, block,
                                       form[:5] + (True,), modes=(1,) *
                                       form[0], ridder_iters=5.0)[0]


@pytest.mark.parametrize("dims", [SMOKE_2D_DIMS, SMOKE_3D_DIMS, (64, 16, 8),
                                  (12, 8, 3)])
def test_wavefront_ctas_cover_the_tiles_of_a_plane(dims):
    """the persistent CTAs of a sweep, every form's: at least
    the tiles that share a hyperplane, counted tile by tile here (a tile
    spans the planes of its first through its last cell), 1.25 x that
    where the block has so many tiles, never more than the tiles"""
    tile = imp.sweep_tile(dims)
    table = imp.tile_table(dims, tile)
    first = table[:, :3].sum(axis=1)
    last = first + table[:, 3:].sum(axis=1) - 3
    most = max(int(((first <= p) & (p <= last)).sum())
               for p in range(int(last.max()) + 1))
    ctas = imp.wavefront_ctas(dims, tile)
    assert ctas == min(len(table), -(-5 * most // 4))
    assert most <= ctas <= len(table)


@pytest.mark.parametrize("name", ["lusgs_sweep_tp", "lusgs_sweep_roe_tp_ns7",
                                  "lusgs_sweep_roe", "blusgs_sweep_tp",
                                  "blusgs_sweep_roe_tp", "lusgs_sweep",
                                  "blusgs_sweep", "blusgs_sweep_ns7"])
def test_probe_builds_resolve(name):
    """a sweep's (any build, scalar or block) build with the step clocks'
    marks (``utils/sweep_probe.py``, ``lusgs_sweep.clock_breakdown``) is
    its own build with ``-DSWEEP_PROBE=1``; no production build and no
    other library has marks"""
    from aither_tpu_torch.utils import build
    source, defines = build.library_source(name)
    assert "-DSWEEP_PROBE=1" not in defines
    assert build.library_source(f"{name}_probe") == (
        source, defines + ("-DSWEEP_PROBE=1",))
    assert build.library_source("viscous_march") == ("viscous_march", ())
