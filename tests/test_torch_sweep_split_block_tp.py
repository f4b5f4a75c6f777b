"""PyTorch port, the block thermally perfect sweeps' decomposition
(``csrc/blusgs_sweep.cu`` built with ``-DSWEEP_TP=1``, and with
``-DSWEEP_ROE=1`` as well), held on the CPU against the JAX package's
functions, without a JAX Solver:

1. a plain twin of the Rusanov forms' pre-pass (``store_cell_terms``: per
   state the mixture's gamma, energy, conductivity, cp and species
   enthalpies; a calorically perfect form stores the conductivity alone
   and its lanes evaluate the rest, as the twin does) against the JAX
   Physics' functions (1e-13 of each term's largest value; they differ by
   3e-16);
2. a plain twin of the lanes' product from those stored terms (the
   kernel's ``add_block_offdiagonal_mix``: the Rusanov rows, the
   thin-shear-layer rows with Schmidt diffusion and the turbulence
   diagonal, the two addends summed), forward and backward, against
   ``aither_tpu.solver.implicit.offdiagonal_block_channels`` and the
   port's plain version (1e-13 of each row's largest value over the
   batch, where they differ by 1e-15: the twin keeps the kernel's
   association, not the plain row matvec's);
3. the approximateRoe forms' split (the old Roe flux and radii per face,
   each updated state's q + du from its stored old energy, inverted once
   per state by the stage): per face gathered from the once-per-state
   inversion, equal bit for bit to the port's ``implicit.offdiagonal``
   and within 5e-11 of each row's largest value of the JAX package's
   ``roe_offdiagonal`` (the updated T of the two packages' Ridder loops
   differ in their last places, which the two Roe fluxes of q + du carry
   to 9e-12 of the rows on this plate), and the stage's inversion of each
   updated state (four points an iteration) against the JAX Physics'
   ``temperature_from_energy`` (1e-12 relative, as
   ``test_torch_thermo.py``);
4. ``prepass_form``, ``staged_form``, ``work_doubles``, ``prepass_bytes``
   and ``sweep_cost`` of both forms at case-A and case-B sized plans.

Decks (a 2 x 6x5x3 plate, blusgs): hot one-species SST and Wilcox air
(``cases.TP_AIR``), laminar frozen five-species air with Schmidt
diffusion, the P5 mixture ``n2o2_ch4x`` (SST, Schmidt, a species of
eleven vibrational modes) and hot air with ``approximateRoe``; and for
the product, the calorically perfect viscous Rusanov decks whose pre-pass
stores the conductivity: one-species SST (the blusgs path) and Wilcox,
N2/O2 SST with Schmidt diffusion and laminar frozen five-species air.
"""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aither_tpu_torch.cases import (MIXTURES, SMOKE_2D_DIMS,  # noqa: E402
                                    SMOKE_3D_DIMS, TP_AIR, write_plate_case)
from aither_tpu_torch.kernels import lusgs_sweep as ls  # noqa: E402
from aither_tpu_torch.solver import implicit as imp  # noqa: E402
from aither_tpu_torch.solver import state as st  # noqa: E402
from aither_tpu_torch.solver.driver import Solver  # noqa: E402
from aither_tpu_torch.solver.viscous import SST, WILCOX  # noqa: E402
from tests.test_torch_sweep_split import (DIMS, box_plan,  # noqa: E402
                                          group_inversion, old_energy,
                                          old_terms, stage, stored_product)

TERMS_RTOL = 1e-13     # stored terms against the JAX Physics
ROWS_RTOL = 1e-13      # the product from them against both plain versions
ROE_RTOL = 5e-11       # the Roe split against the JAX package
T_RTOL = 1e-12         # the stage's T against the JAX Physics
TP_GAS = dict(thermodynamic_model="thermallyPerfect")
BLOCK = dict(matrix_solver="blusgs")
DECKS = {"hot_air": dict(TP_AIR, **BLOCK),
         "hot_air_wilcox": dict(TP_AIR, turbulence_model="kOmegaWilcox2006",
                                **BLOCK),
         "air5": dict(MIXTURES["air5_frozen"], equation_set="navierStokes",
                      turbulence_model="none", **TP_GAS, **BLOCK),
         "n2o2_ch4x": dict(MIXTURES["n2o2_ch4x"], **TP_GAS, **BLOCK),
         "hot_air_roe": dict(TP_AIR, inviscid_flux_jacobian="approximateRoe",
                             **BLOCK)}
# the calorically perfect viscous Rusanov decks (their conductivity once
# per cell)
CP_DECKS = {"sst_cp": BLOCK,
            "wilcox_cp": dict(turbulence_model="kOmegaWilcox2006", **BLOCK),
            "n2o2_cp": dict(MIXTURES["n2o2"], **BLOCK),
            "air5_cp": dict(MIXTURES["air5_frozen"],
                            equation_set="navierStokes",
                            turbulence_model="none", **BLOCK)}
RUSANOV = ("air5", "hot_air", "hot_air_wilcox", "n2o2_ch4x") + tuple(
    CP_DECKS)
_SYSTEMS = {}


def build_system(name, tmp_path_factory):
    """a deck's port Solver on the CPU, its JAX Physics (no Solver), the
    first residual's state and aux fields (ghosts filled) and a seeded du
    of 1e-3 of each equation's scale on every padded cell; built once a
    deck for the module's fixtures"""
    if name in _SYSTEMS:
        return _SYSTEMS[name]
    from aither_tpu.io.deck import parse_deck
    from aither_tpu.physics.models import Physics as JaxPhysics
    wd = str(tmp_path_factory.mktemp(name))
    path = write_plate_case(wd, *DIMS, **{**DECKS, **CP_DECKS}[name])
    here = os.getcwd()
    os.chdir(wd)   # a tracer's fluid file sits beside the deck
    try:
        jphys = JaxPhysics.from_deck(parse_deck(path).finalize())
        s = Solver(path, device="cpu", workdir=wd)
    finally:
        os.chdir(here)
    prims, _, _, _, _, auxs = s._residuals(dict(s.prims), s.deck.cfl(0))
    rng = np.random.default_rng(17)
    dus = {}
    for bi, q in prims.items():
        scale = q.abs().amax(dim=(1, 2, 3), keepdim=True)
        dus[bi] = 1e-3 * scale * torch.as_tensor(
            rng.uniform(-1.0, 1.0, tuple(q.shape)))
    _SYSTEMS[name] = (name, s, jphys, prims, auxs, dus)
    return _SYSTEMS[name]


@pytest.fixture(scope="module", params=RUSANOV)
def rusanov_system(request, tmp_path_factory):
    return build_system(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def roe_system(tmp_path_factory):
    return build_system("hot_air_roe", tmp_path_factory)


@pytest.fixture(scope="module", params=sorted(DECKS))
def system(request, tmp_path_factory):
    return build_system(request.param, tmp_path_factory)


def _j(x):
    """a JAX array of a CPU tensor's values"""
    return jnp.asarray(x.numpy())


def faces(s, prims, auxs, dus, forward, per_block=None):
    """the unmasked faces of a sweep side of every block and direction in
    one batch (one JAX evaluation of each shape): (q_nb, du_nb, q_cell, n,
    mag, the viscous keywords with vgrad); ``per_block`` {block: (C,
    padded cells)} adds its values at the faces' neighbours"""
    side = "lower" if forward else "upper"
    sign = -1 if forward else 1
    parts = []
    for bi, plan in s.plans.items():
        C = prims[bi].shape[0]
        qf, duf = prims[bi].reshape(C, -1), dus[bi].reshape(C, -1)
        aux = {k: auxs[bi][k].reshape(-1) for k in ("mu", "mut", "f1")}
        vg = auxs[bi]["vgrad"].reshape(9, -1)
        mask = plan.mask[side][plan.phys_cells]
        for d in range(3):
            m = mask[:, d]
            cell = plan.cells[m]
            nb = cell + sign * plan.strides[d]
            stat = plan.static[side][plan.phys_cells[m], d]
            parts.append([qf[:, nb], duf[:, nb], qf[:, cell], stat[:, 0:3].T,
                          stat[:, 3], stat[:, 4], aux["mu"][nb],
                          aux["mut"][nb], aux["f1"][nb], vg[:, nb]]
                         + ([] if per_block is None
                            else [per_block[bi][:, nb]]))
    cat = [torch.cat(x, dim=-1) for x in zip(*parts)]
    q, dq, qc, n, mag, dist, mu, mut, f1, vg = cat[:10]
    kw = dict(dist=dist, mu=mu, mut=mut, f1=f1, vgrad=vg.reshape(3, 3, -1))
    return (q, dq, qc, n, mag, kw) + tuple(cat[10:])


def _close(got, want, rtol, what):
    """|got - want| within rtol of each row's largest |want|"""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    g, w = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    scale = np.abs(w).max(axis=1, keepdims=True)
    assert np.all(np.isfinite(g)), what
    assert np.all(np.abs(g - w) <= rtol * scale), (
        what, float((np.abs(g - w) / np.where(scale > 0, scale, 1)).max()))


# ---------------------------------------------------------------------------
# the Rusanov forms: the pre-pass's terms and the product from them


def cell_terms(phys, q):
    """the pre-pass of a batch of states (``store_cell_terms``): the
    mixture's gamma and energy sum_s mf_s e_s(T), its conductivity times
    the nondimensional scaling, its cp and the species' enthalpies h_s(T)"""
    t = st.temperature(phys, q)
    mf = st.mixture_fractions(phys, q)
    terms = dict(gamma=phys.gamma(t, mf),
                 energy=phys.mix(phys.species_energy(t), mf),
                 k=phys.nondim_scaling * phys.conductivity(t, mf),
                 cp=phys.cp(t, mf), h=phys.species_enthalpy(t))
    # one calorically perfect species' gamma and cp are constants
    return {key: v if key == "h" else torch.broadcast_to(
        torch.as_tensor(v, dtype=t.dtype), t.shape)
        for key, v in terms.items()}


def product_from_terms(phys, cfg, q, dq, n, mag, positive, terms, dist, mu,
                       mut, f1, vgrad):
    """a lane's product from the stored terms
    (``add_block_offdiagonal_mix``): the Rusanov rows and the turbulence
    diagonal plus the thin-shear-layer rows (the two addends), in the
    kernel's association"""
    ns, N = phys.ns, phys.ns + 4
    turb = phys.nturb > 0
    rho = q[:ns].sum(dim=0)
    mf = q[:ns] / rho
    u, v, w, p = q[ns], q[ns + 1], q[ns + 2], q[ns + 3]
    gamma, em = terms["gamma"], terms["energy"]
    S = dq[:ns].sum(dim=0)
    n0, n1, n2 = n
    vn = u * n0 + v * n1 + w * n2
    vmag2 = u * u + v * v + w * w
    gm1 = gamma - 1.0
    sgn = 1.0 if positive else -1.0
    dm0, dm1, dm2, de = dq[ns], dq[ns + 1], dq[ns + 2], dq[ns + 3]
    phi = 0.5 * gm1 * vmag2
    a1 = gamma * (em + 0.5 * vmag2) - phi
    a3 = gamma - 2.0
    hm = 0.5 * mag
    spec = hm * (torch.abs(vn) + torch.sqrt(gamma * p / rho))
    ndm = n0 * dm0 + n1 * dm1 + n2 * dm2
    acc = [hm * (vn * dq[s] - mf[s] * vn * S + mf[s] * ndm)
           + sgn * spec * dq[s] for s in range(ns)]
    for a, (na, va) in enumerate(((n0, u), (n1, v), (n2, w))):
        cols = (dm0, dm1, dm2)
        row = (phi * na - va * vn) * S + gm1 * na * de
        for b, (nb_, vb) in enumerate(((n0, u), (n1, v), (n2, w))):
            row = row + ((vn - a3 * na * va) if a == b
                         else (va * nb_ - gm1 * vb * na)) * cols[b]
        acc.append(hm * row + sgn * spec * cols[a])
    acc.append(hm * (vn * (phi - a1) * S + (a1 * n0 - gm1 * u * vn) * dm0
                     + (a1 * n1 - gm1 * v * vn) * dm1
                     + (a1 * n2 - gm1 * w * vn) * dm2 + gamma * vn * de)
               + sgn * spec * de)
    acc_t = [torch.zeros_like(vn) for _ in range(N)]
    if cfg.get("viscous"):
        t = p / sum(r * q[s] for s, r in enumerate(phys.R))
        mu_s, mut_s = phys.nondim_scaling * mu, phys.nondim_scaling * mut
        mu_tot = mu_s + mut_s
        s_ = -1.0 if positive else 1.0
        kt = mut_s * terms["cp"] / phys.turb_prandtl() if turb else 0.0
        g = vgrad.reshape(9, -1)
        lt = -2.0 / 3.0 * mu_tot * (g[0] + g[4] + g[8])
        tau = [lt * nn + mu_tot * ((g[3 * a] + g[a]) * n0
                                   + (g[3 * a + 1] + g[3 + a]) * n1
                                   + (g[3 * a + 2] + g[6 + a]) * n2)
               for a, nn in enumerate(n)]
        ir = 1.0 / rho
        dp = [-ir * va * S + ir * dma
              for va, dma in ((u, dm0), (v, dm1), (w, dm2))]
        dp4 = (0.5 * gm1 * vmag2 * S - gm1 * u * dm0 - gm1 * v * dm1
               - gm1 * w * dm2 + gm1 * de)
        scale = s_ * (mag * mu_tot / dist)
        third = 1.0 / 3.0
        ndp = third * (n0 * dp[0] + n1 * dp[1] + n2 * dp[2])
        for a in range(3):
            acc_t[ns + a] = scale * (dp[a] + n[a] * ndp)
        kk = (terms["k"] + kt) / (mu_tot * rho)
        hd = s_ * 0.5 * dist / mu_tot
        e_species = -kk * t * S
        if cfg.get("diffusion", "none") != "none":
            dc = (mu_s / cfg["schmidt"] + mut_s / cfg["turb_schmidt"]) / (
                mu_tot * rho)
            for s in range(ns):
                acc_t[s] = scale * (dc * (dq[s] - mf[s] * S))
                e_species = e_species + dc * (1.0 - mf[s]) * (
                    terms["h"][s] + 0.5 * vmag2) * dq[s]
        acc_t[ns + 3] = scale * (
            e_species + sum((hd * tau[a] + third * n[a] * vn + va) * dp[a]
                            for a, va in enumerate((u, v, w))) + kk * dp4)
    out = torch.stack([x + y for x, y in zip(acc, acc_t)])
    if not turb:
        return out
    tdiag = 0.5 * vn * mag + sgn * (0.5 * torch.abs(vn) * mag)
    length = phys.nondim_scaling * mag / dist / rho
    if cfg["turb_model"] == "kOmegaWilcox2006":
        sk, sw = WILCOX["sigma_star"], WILCOX["sigma"]
        mutx = rho * q[N] / q[N + 1]
    else:
        sk = f1 * SST["sigma_k1"] + (1.0 - f1) * SST["sigma_k2"]
        sw = f1 * SST["sigma_w1"] + (1.0 - f1) * SST["sigma_w2"]
        mutx = mut
    return torch.cat([out, torch.stack([
        (tdiag + length * (mu + sk * mutx)) * dq[N],
        (tdiag + length * (mu + sw * mutx)) * dq[N + 1]])])


def jax_terms(jphys, q):
    """the JAX Physics' values of ``cell_terms`` on the same states"""
    ns = jphys.ns
    qj = _j(q)
    rho = qj[:ns].sum(axis=0)
    mf = qj[:ns] / rho
    t = qj[ns + 3] / sum(r * qj[s] for s, r in enumerate(jphys.R))
    terms = dict(gamma=jphys.gamma(t, mf),
                 energy=jphys.mix(jphys.species_energy(t), mf),
                 k=jphys.nondim_scaling * jphys.conductivity(t, mf),
                 cp=jphys.mix(jphys.species_cp(t), mf),
                 h=jphys.species_enthalpy(t))
    return {key: v if key == "h" else jnp.broadcast_to(v, t.shape)
            for key, v in terms.items()}


@pytest.mark.parametrize("forward", [True, False])
def test_block_prepass_terms_and_product(rusanov_system, forward):
    """per unmasked face of both sweep sides: the stored terms of the
    neighbour state against the JAX Physics, and the product from them
    against the JAX package's ``offdiagonal_block_channels`` and the
    port's"""
    from aither_tpu.solver import implicit as jimp
    name, s, jphys, prims, auxs, dus = rusanov_system
    phys, cfg = s.phys, s.cfg
    form = ls.sweep_form(phys, cfg)
    assert not form[4] and form[5] == (name not in CP_DECKS)
    assert ls.prepass_form(form, True) and not ls.staged_form(form, True)
    q, dq, _, n, mag, kw = faces(s, prims, auxs, dus, forward)
    assert q.shape[1] > 0
    terms = cell_terms(phys, q)
    want_terms = jax_terms(jphys, q)
    for key in ("gamma", "energy", "k", "cp"):
        _close(terms[key][None], want_terms[key][None], TERMS_RTOL,
               f"{name} {key}")
    _close(terms["h"], want_terms["h"], TERMS_RTOL, f"{name} h_s")
    got = product_from_terms(phys, cfg, q, dq, n, mag, forward, terms, **kw)
    plain = imp.offdiagonal_block_channels(phys, cfg, q, dq, n, mag, forward,
                                           **kw)
    want = jimp.offdiagonal_block_channels(
        jphys, cfg, _j(q), _j(dq), _j(n), _j(mag), forward,
        **{k: _j(v) for k, v in kw.items()})
    _close(got, plain, ROWS_RTOL, f"{name} against the port's plain")
    _close(got, want, ROWS_RTOL, f"{name} against the JAX package's")


# ---------------------------------------------------------------------------
# the approximateRoe forms: the stage's one inversion per state


def stage_states(phys, q, du):
    """the stage of every padded cell at once (once per state): q + du
    from the state's stored old energy"""
    return stage(phys, q, du, old_energy(phys, q))


@pytest.mark.parametrize("forward", [True, False])
def test_roe_split_one_inversion_per_state(roe_system, forward):
    """the block Roe form's product from its pre-pass terms (per face) and
    each neighbour's q + du inverted once per padded cell: bit for bit
    the port's plain ``implicit.offdiagonal``, and the JAX package's
    ``roe_offdiagonal`` within ROE_RTOL"""
    from aither_tpu.solver import implicit as jimp
    name, s, jphys, prims, auxs, dus = roe_system
    phys, cfg = s.phys, s.cfg
    form = ls.sweep_form(phys, cfg)
    assert form[4] and form[5] and ls.staged_form(form, True)
    staged = {bi: stage_states(phys, q.reshape(q.shape[0], -1),
                               dus[bi].reshape(q.shape[0], -1))
              for bi, q in prims.items()}
    q, dq, qc, n, mag, kw, qu = faces(s, prims, auxs, dus, forward, staged)
    assert q.shape[1] > 0
    kw.pop("vgrad")
    old, sr, sr_t = old_terms(phys, cfg, q, qc, n, mag, forward, **kw)
    got = stored_product(phys, cfg, qu, dq, qc, n, mag, forward, old, sr,
                         sr_t)
    plain = imp.offdiagonal(phys, cfg, q, dq, n, mag, forward, q_diag=qc,
                            **kw)
    assert bool(torch.isfinite(plain).all())
    assert torch.equal(got, plain)
    want = jimp.roe_offdiagonal(jphys, cfg, _j(q), _j(qc), _j(dq), _j(n),
                                _j(mag), forward,
                                **{k: _j(v) for k, v in kw.items()})
    _close(got, want, ROE_RTOL, f"{name} against the JAX package's")


def test_stage_inversion_is_the_jax_physics(system):
    """the stage's four-point inversion (``group_inversion``) of every
    padded cell's q + du against the JAX Physics' Ridder loop"""
    name, s, jphys, prims, _, dus = system
    phys = s.phys
    for bi, q in prims.items():
        cons = st.cons_from_prim(phys, q) + dus[bi]
        r = cons[:phys.ns].sum(dim=0)
        vel = cons[phys.mx:phys.mx + 3] / r[None]
        e = cons[phys.ie] / r - 0.5 * (vel * vel).sum(dim=0)
        mf = st.mixture_fractions(phys, cons)
        got = group_inversion(phys, e, mf)
        mfj = jnp.ones((1,) + tuple(e.shape)) if mf is None else _j(mf)
        want = jphys.temperature_from_energy(_j(e), mfj)
        _close(got[None], np.asarray(want)[None], T_RTOL, f"{name} T")


# ---------------------------------------------------------------------------
# the work space and the bound


@pytest.mark.parametrize("form,diffusion,stored,read", [
    ((1, 5, False, False, False, True), False, 2, 2),
    ((1, 5, True, False, False, True), False, 5, 3),
    ((1, 7, True, True, False, True), False, 5, 4),
    ((2, 8, True, False, False, True), True, 6, 6),
    ((3, 9, True, False, False, True), True, 7, 7),
    ((5, 9, True, False, False, True), True, 9, 8)],
    ids=["euler", "laminar", "wilcox", "n2o2", "p5", "air5"])
def test_block_tp_cell_terms_by_form(form, diffusion, stored, read):
    """a block thermally perfect Rusanov form's cell terms: room for
    gamma and the energy, and viscous for the conductivity, cp and each
    species' enthalpy (``cell_values``, the work space per padded cell);
    written and read, gamma and the energy, the conductivity when
    viscous, cp with turbulence equations and the enthalpies with
    Schmidt diffusion (``cell_terms_read``); no stage, unlike the form's
    approximateRoe twin"""
    plan = types.SimpleNamespace(padded=(10, 9, 5), dims=(6, 5, 1))
    assert ls.cell_values(form) == stored
    assert ls.cell_terms_read(form, diffusion) == read
    assert ls.work_doubles(form, plan, True) == stored * 10 * 9 * 5
    assert not ls.staged_form(form, True)
    roe = form[:4] + (True, True)
    assert ls.staged_form(roe, True)
    assert ls.work_doubles(roe, plan, True) == (
        ls.face_values(roe) * 3 * 30 + 30 + form[1] * 450)


@pytest.mark.parametrize("dims", [SMOKE_2D_DIMS, SMOKE_3D_DIMS],
                         ids=["case_A", "case_B"])
def test_block_tp_work_space_and_cost(dims):
    """the block thermally perfect forms take the pre-pass and the
    persistent CTAs; the Rusanov form's work space holds its cell terms
    per padded cell, its traffic (written per physical cell and ghost
    read, read per unmasked face) outside the bound, and its
    thermodynamics counts once per neighbour state; the Roe form's holds
    its face terms, the old energies and the updated states, and it
    inverts q + du once per updated state (the distinct neighbours read).
    At case B the costs that read no other form's (each count there is a
    unique of 1.5M neighbour indices)"""
    plan = box_plan(*dims)
    g = 2
    plan.padded = tuple(n + 2 * g for n in dims)
    plan.dims = dims
    ni, nj, nk = dims
    NI, NJ, NK = plan.padded
    ncp, nc = ni * nj * nk, NI * NJ * NK
    nfaces = ((ni - 1) * nj * nk + ni * (nj - 1) * nk + ni * nj * (nk - 1))
    forward = True
    nread, nghost = ls.neighbour_reads(plan, forward)
    assert (nread, nghost) == (ncp - 1, 0)
    tp = ls.SST_FORM[:5] + (True,)
    roe_tp = ls.SST_FORM[:4] + (True, True)
    for form in (tp, roe_tp):
        assert ls.prepass_form(form)
        assert ls.staged_form(form) and ls.staged_form(form, True) == (
            form is roe_tp)
    # the Rusanov form: gamma, e, k, cp and one species' enthalpy a cell
    assert ls.cell_values(tp) == 5
    assert ls.work_doubles(tp, plan, True) == 5 * nc
    assert ls.cell_terms_read(tp, False) == 4
    assert ls.cell_terms_read((2, 8, True, False, False, True), True) == 6
    assert ls.cell_terms_read((5, 9, True, False, False, True), True) == 8
    assert ls.cell_terms_read((1, 5, False, False, False, True), False) == 2
    assert ls.prepass_bytes(plan, forward, tp, True) == 8 * 4 * (
        ncp + nghost + nfaces)
    cost = ls.sweep_cost(plan, forward, False, True, tp, modes=(1,))
    per_cell = 2 * 5 * 5 + 5 + 8
    assert cost[1] == (ls.mixture_neighbour_ops(tp, True, False) * nfaces
                       + ls.tp_extra_ops(tp, (1,), True, False) * nread
                       + per_cell * ncp)
    # the Roe form: the scalar thermally perfect forms' layout
    nv = ls.face_values(roe_tp)
    assert nv == 9
    assert ls.work_doubles(roe_tp, plan, True) == (nv * 3 * ncp + ncp
                                                   + 7 * nc)
    assert ls.prepass_bytes(plan, forward, roe_tp, True) == 8 * 2 * (
        nv * nfaces + ncp + 7 * nread)
    if dims == SMOKE_3D_DIMS:
        return
    # the function's bytes, those of the calorically perfect forms
    assert cost[0] == ls.sweep_cost(plan, forward, False, True,
                                    tp[:5] + (False,))[0]
    costs = [ls.sweep_cost(plan, forward, False, True, roe_tp, modes=(1,),
                           ridder_iters=it) for it in (5.0, 10.0)]
    assert costs[0][0] == ls.sweep_cost(plan, forward, False, True,
                                        roe_tp[:5] + (False,))[0]
    # 10 more energy evaluations of 4 + 5 operations, 5 brackets of 19
    assert costs[1][1] - costs[0][1] == (10 * 9 + 5 * 19) * nread
    per_nb = (ls.roe_mixture_neighbour_ops(roe_tp)
              + ls.tp_roe_extra_ops(roe_tp, (1,)))
    per_state = ls.state_ops(roe_tp) + ls.tp_state_ops(roe_tp, (1,), 5.0)
    assert costs[0][1] == ((per_nb - ls.state_ops(roe_tp)) * nfaces
                           + per_state * nread + per_cell * ncp)
