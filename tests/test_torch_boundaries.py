"""PyTorch port, the boundary conditions at function level against
aither_tpu: every ghost-state function the port gained with the inlet,
stagnation inlet, pressure outlet, supersonic in/outflow and the wall law,
on random boundary patches (no Solver compile), and the annular sector of
tests/gridgen.py (rotational periodic j faces, supersonic in/outflow on
the k faces) as a whole deck.

Functions (float64, inputs from ``np.random.default_rng`` with the seeds
below; each channel within 1e-12 of its own scale: the same expressions
in the same order on both sides, libm and XLA round a few ulp apart), for
one species with turbulence equations (SST) and for N2/O2 without
(laminar), at ghost layers 1 and 2:
``make_bc_data`` of every boundary state; ``inlet`` and
``pressure_outlet`` in their reflecting and LODI forms, each patch with
subsonic and supersonic faces; ``supersonic_inflow``,
``supersonic_outflow`` and ``stagnation_inlet``; ``solve_wall_law`` for an
isothermal, an adiabatic and a heat-flux wall on slabs whose wall
distances span four decades, so that some faces bracket their root in
[10, 1e4] and the others do not (y+ = 1e4 there; the share is printed and
asserted strictly between 0 and 1); the wall-law ``viscous_wall`` ghosts
and the wall values it stores.  The Ridder iteration is held to 1e-10
instead: its last step amplifies the residual function's last-ulp
differences by the bracket's conditioning (measured 1e-13 to 1e-11 of
y+ on these slabs).

The JAX package's wall law never takes its y+ < 10 low-Re switch: the
root lies in the bracket [10, 1e4] or is not bracketed and set to 1e4
(cases.WALL_LAW_CLUSTER).
The viscous residual's wall-law faces are therefore also held with a
``low_re`` mask set on half the faces by hand (the same mask on both
sides), so that both branches of every wall-law selection run, with the
cell-average pressure gradient of the LODI decks (``need_pgrad``) and the
block solver's TSL diagonals.

Deck (the JAX side on its scan sweep path, ``quick_jax_compiles``): the
annular sector (Euler, lusgs, one block of 16x12x8 cells, periodic with
itself) from a 1%-perturbed state: its full ghost fill (1e-12), one
iteration (1e-10) and a 3-iteration raw L2 history (1e-8), the
tolerances of tests/test_torch_slice.py, from one JAX compile.  The
plate's decks are in tests/test_torch_bc_decks.py.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aither_tpu_torch.cases import N2O2, write_plate_case  # noqa: E402
from tests.torch_parity import (check_history, check_one_iteration,  # noqa
                                jax_solver, np_, perturbed_prims,
                                quick_jax_compiles, rel_err, torch_solver)

TOL = 1e-12
RIDDER_TOL = 1e-10
SHAPE = (6, 5)          # faces of a patch

# name -> write_plate_case keywords: one species with turbulence
# equations, two species without
PHYSICS = {"sst": {},
           "n2o2_laminar": dict(N2O2, equation_set="navierStokes",
                                turbulence_model="none")}


@pytest.fixture(scope="module", autouse=True)
def _quick_compiles():
    with quick_jax_compiles():
        yield


@pytest.fixture(scope="module")
def physics(tmp_path_factory):
    """{name: (JAX Solver, port Solver)} of the plate of each physics on
    2 x 4x3x2 cells, with every new boundary state in its deck (nothing
    is run)"""
    out = {}
    for name, kw in PHYSICS.items():
        wd = tmp_path_factory.mktemp(name)
        path = write_plate_case(str(wd), 4, 3, 2, inflow="stagnationInlet",
                                outflow="pressureOutlet",
                                wall_treatment="wallLaw", **kw)
        out[name] = (jax_solver(path, wd), torch_solver(path, wd))
    return out


def _close(got, want, what, tol=TOL):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(want)), what
    for e in range(want.shape[0]):
        assert rel_err(got[e], want[e]) < tol, (what, e, rel_err(got[e],
                                                               want[e]))


def _unit(rng, shape):
    n = rng.standard_normal((3,) + shape)
    return n / np.linalg.norm(n, axis=0)


def _patch(phys, rng, norm, speed):
    """a patch state around the plate's freestream whose velocity is
    ``speed`` (per face) times the outward normal plus a small tangential
    part"""
    shape = norm.shape[1:]
    q = np.empty((phys.neq,) + shape)
    rho = 1.0 + 0.1 * rng.random(shape)
    mf = np.array([1.0] if phys.ns == 1 else N2O2["mass_fractions"])
    q[:phys.ns] = mf.reshape((-1, 1, 1)) * rho
    q[phys.mx:phys.mx + 3] = (speed * norm
                              + 0.05 * rng.standard_normal((3,) + shape))
    q[phys.ie] = 0.714 * (1.0 + 0.1 * rng.random(shape))
    if phys.nturb:
        q[phys.it] = 1e-4 * (1.0 + rng.random(shape))
        q[phys.it + 1] = 10.0 * (1.0 + rng.random(shape))
    return q


def _data(phys, jbc, tbc, **kw):
    """(JAX BCData, port BCData) with the same fields: the plate's
    nondimensional freestream and the given ones"""
    mf = (1.0,) if phys.ns == 1 else N2O2["mass_fractions"]
    base = dict(velocity=(0.2, 0.01, 0.0), density=1.0, pressure=0.714,
                mass_fractions=mf, turb_intensity=0.01, eddy_visc_ratio=10.0,
                length_scale=1.0)
    base.update(kw)
    return jbc.BCData(**base), tbc.BCData(**base)


def _lodi(rng, q, shape):
    """the LODI keywords of one patch: time-n state, dt, the patch's Mach
    statistics, pressure and velocity gradients"""
    return dict(state_n=q * (1.0 + 0.01 * rng.random(q.shape)),
                dt=0.01 + 0.1 * rng.random(shape), max_mach=np.float64(0.6),
                avg_mach=np.float64(0.3),
                pgrad=0.1 * rng.standard_normal((3,) + shape),
                vgrad=rng.standard_normal((3, 3) + shape))


def _call(pkg, fn, phys, q, norm, data, layer, kw):
    conv = jnp.asarray if pkg == "jax" else torch.as_tensor
    kw = {k: conv(v) for k, v in kw.items()}
    return getattr(pkg_bc(pkg), fn)(phys, conv(q), conv(norm), data, layer,
                                    **kw)


def pkg_bc(pkg):
    if pkg == "jax":
        from aither_tpu.solver import bc
    else:
        from aither_tpu_torch.solver import bc
    return bc


def test_make_bc_data(physics):
    """every boundary state of the generated decks, with the LODI keys and
    the wall law, nondimensionalised alike"""
    from aither_tpu.solver import bc as jbc
    from aither_tpu_torch.solver import bc as tbc
    for name, (js, ts) in physics.items():
        deck = ts.deck
        assert len(deck.bc_states) >= 4
        for state in deck.bc_states:
            if state.name == "periodic":
                continue
            want = dataclasses.asdict(jbc.make_bc_data(state, js.deck))
            got = dataclasses.asdict(tbc.make_bc_data(state, deck))
            assert got == want, (name, state.name)
    wd = os.path.dirname(physics["sst"][1].sim_root)
    path = write_plate_case(os.path.join(wd, "lodi"), 4, 3, 2,
                            inflow="inlet", outflow="pressureOutlet",
                            nonreflecting=True)
    js, ts = jax_solver(path, wd), torch_solver(path, wd)
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        for js_, ts_ in zip(jb.surfaces, tb.surfaces):
            assert (dataclasses.asdict(ts_.data) if ts_.data else None) == (
                dataclasses.asdict(js_.data) if js_.data else None)
    assert ts.cfg["need_pgrad"] and js.cfg["need_pgrad"]
    assert not physics["sst"][1].cfg["need_pgrad"]


@pytest.mark.parametrize("name", sorted(PHYSICS))
@pytest.mark.parametrize("fn", ["inlet", "pressure_outlet"])
@pytest.mark.parametrize("lodi", [False, True], ids=["reflecting", "lodi"])
def test_inlet_and_pressure_outlet(physics, name, fn, lodi):
    from aither_tpu.solver import bc as jbc
    from aither_tpu_torch.solver import bc as tbc
    js, ts = physics[name]
    rng = np.random.default_rng(11)
    norm = _unit(rng, SHAPE)
    # inflow for the inlet, outflow for the outlet, |vn| / a from 0.05 to
    # 1.6: subsonic and supersonic faces on one patch
    sign = -1.0 if fn == "inlet" else 1.0
    speed = sign * np.linspace(0.05, 1.6, np.prod(SHAPE)).reshape(SHAPE)
    q = _patch(ts.phys, rng, norm, speed)
    jd, td = _data(ts.phys, jbc, tbc, nonreflecting=lodi)
    kw = _lodi(rng, q, SHAPE) if lodi else {}
    for layer in (1, 2):
        want = _call("jax", fn, js.phys, q, norm, jd, layer, kw)
        got = _call("torch", fn, ts.phys, q, norm, td, layer, kw)
        _close(got, want, f"{fn} {name} layer {layer}")


@pytest.mark.parametrize("name", sorted(PHYSICS))
@pytest.mark.parametrize("fn", ["supersonic_inflow", "supersonic_outflow",
                                "stagnation_inlet"])
def test_other_inflow_outflow(physics, name, fn):
    from aither_tpu.solver import bc as jbc
    from aither_tpu_torch.solver import bc as tbc
    js, ts = physics[name]
    rng = np.random.default_rng(12)
    norm = _unit(rng, SHAPE)
    speed = -0.05 - 0.3 * rng.random(SHAPE)
    q = _patch(ts.phys, rng, norm, speed)
    t = np.asarray(js.phys.temperature(jnp.asarray(q[ts.phys.ie]),
                                       jnp.asarray(q[:ts.phys.ns])))
    t0 = 1.05 * float(t.max())
    jd, td = _data(ts.phys, jbc, tbc, stagnation_temperature=t0,
                   stagnation_pressure=0.714 * 1.05 ** 3.5,
                   direction=(0.8, 0.6, 0.0))
    for layer in (1, 2):
        want = _call("jax", fn, js.phys, q, norm, jd, layer, {})
        got = _call("torch", fn, ts.phys, q, norm, td, layer, {})
        _close(got, want, f"{fn} {name} layer {layer}")


WALLS = {"isothermal": dict(t_wall=1.0), "adiabatic": {},
         "heat_flux": dict(heat_flux=-2e-3)}


def _wall_slab(phys, rng):
    """wall-adjacent states with a tangential velocity of 0.1-0.3 and wall
    distances from 1e-7 to 1e-3 (reference length 1 m)"""
    norm = _unit(rng, SHAPE)
    q = _patch(phys, rng, norm, np.zeros(SHAPE))
    tang = rng.standard_normal((3,) + SHAPE)
    tang -= (tang * norm).sum(axis=0) * norm
    tang /= np.linalg.norm(tang, axis=0)
    q[phys.mx:phys.mx + 3] = (0.1 + 0.2 * rng.random(SHAPE)) * tang
    wd = np.logspace(-7, -3, np.prod(SHAPE)).reshape(SHAPE)
    return q, norm, wd


@pytest.mark.parametrize("name", sorted(PHYSICS))
@pytest.mark.parametrize("wall", sorted(WALLS))
def test_solve_wall_law(physics, name, wall):
    from aither_tpu.solver import wall_law as jwl
    from aither_tpu_torch.solver import wall_law as twl
    js, ts = physics[name]
    q, norm, wd = _wall_slab(ts.phys, np.random.default_rng(13))
    kw = dict(von_karmen=0.41, wall_const=5.5, vel_wall=(0.0, 0.0, 0.0),
              **WALLS[wall])
    want = jwl.solve_wall_law(js.phys, js.cfg, jnp.asarray(q),
                              jnp.asarray(norm), jnp.asarray(wd), **kw)
    got = twl.solve_wall_law(ts.phys, ts.cfg, torch.as_tensor(q),
                             torch.as_tensor(norm), torch.as_tensor(wd),
                             **kw)
    assert set(got) == set(want)
    yplus = np_(want["yplus"])
    bracketed = float((yplus < twl.YPLUS_HI).mean())
    print(f"{name} {wall}: share of faces with y+ >= 10 "
          f"{float((yplus >= 10.0).mean()):.3f}, bracketed in [10, 1e4) "
          f"{bracketed:.3f}")
    assert 0.0 < bracketed < 1.0
    np.testing.assert_array_equal(np_(got["low_re"]), np_(want["low_re"]))
    for key in sorted(set(want) - {"low_re"}):
        w = np_(want[key])
        w = w if w.ndim == 3 else w[None]
        g = np_(got[key])
        _close(g if g.ndim == 3 else g[None], w, f"{name} {wall} {key}",
               RIDDER_TOL)


@pytest.mark.parametrize("name", sorted(PHYSICS))
@pytest.mark.parametrize("wall", sorted(WALLS))
def test_wall_law_viscous_wall(physics, name, wall):
    """the wall-law ghosts at layers 1 and 2 and the wall values stored"""
    from aither_tpu.solver import bc as jbc
    from aither_tpu_torch.solver import bc as tbc
    js, ts = physics[name]
    rng = np.random.default_rng(14)
    q, norm, wd = _wall_slab(ts.phys, rng)
    nu_w = 1e-2 * (1.0 + rng.random(SHAPE))
    fields = dict(wall_law=True, velocity=(0.0, 0.0, 0.0))
    if wall == "isothermal":
        fields.update(is_isothermal=True, temperature=1.0)
    elif wall == "heat_flux":
        fields.update(is_constant_heat_flux=True, heat_flux=-2e-3)
    jd, td = _data(ts.phys, jbc, tbc, **fields)
    for layer in (1, 2):
        jw, tw = {}, {}
        want = jbc.viscous_wall(js.phys, jnp.asarray(q), jnp.asarray(norm),
                                jd, layer, wall_dist=jnp.asarray(wd),
                                nu_w=jnp.asarray(nu_w), cfg=js.cfg,
                                wvars_out=jw)
        got = tbc.viscous_wall(ts.phys, torch.as_tensor(q),
                               torch.as_tensor(norm), td, layer,
                               wall_dist=torch.as_tensor(wd),
                               nu_w=torch.as_tensor(nu_w), cfg=ts.cfg,
                               wvars_out=tw)
        _close(got, want, f"{name} {wall} layer {layer}", RIDDER_TOL)
        assert set(tw) == set(jw)
        _close(tw["tau"], jw["tau"], "tau", RIDDER_TOL)


def test_wall_law_viscous_residual(tmp_path):
    """the plain viscous residual of a wall-law plate (SST, blusgs: the
    residual, radii, diagonals and cell averages of the scalar solver and
    the TSL block diagonals besides) with the pressure gradient, its
    wall-law faces' low-Re switch set on some faces by hand in both
    packages' wall data"""
    solver = "blusgs"
    from aither_tpu.solver import step as jstep
    from aither_tpu.solver import viscous as jvis
    from aither_tpu_torch.solver import step as tstep
    from aither_tpu_torch.solver import viscous as tvis
    path = write_plate_case(str(tmp_path), 6, 5, 2, matrix_solver=solver,
                            inflow="stagnationInlet",
                            outflow="pressureOutlet",
                            wall_treatment="wallLaw")
    js, ts = jax_solver(path, tmp_path), torch_solver(path, tmp_path)
    # the full ghost fill is held in tests/test_torch_bc_decks.py: both
    # viscous passes start from the port's
    tfill = tstep.apply_all_bcs(ts.phys, ts.case,
                                {b: torch.as_tensor(v) for b, v in
                                 perturbed_prims(ts.case.blocks).items()})
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        def viscous_ghosts(prim, jb=jb):
            wall = {}
            prim = jstep.apply_boundary_ghosts(js.phys, jb, prim,
                                               viscous_pass=True, cfg=js.cfg,
                                               wall_data=wall)
            return (jstep.apply_edge_ghosts(js.phys, jb, prim,
                                            viscous_pass=True), wall)

        jp, jw = jax.jit(viscous_ghosts)(jnp.asarray(tfill[tb.index].numpy()))
        tw = {}
        tp = tstep.apply_boundary_ghosts(ts.phys, tb, tfill[tb.index],
                                         viscous_pass=True, cfg=ts.cfg,
                                         wall_data=tw)
        tp = tstep.apply_edge_ghosts(ts.phys, tb, tp, viscous_pass=True)
        _close(tp, jp, f"viscous ghosts block {tb.index}", RIDDER_TOL)
        assert len(jw) == len(tw) == 1
        (jv,), (tv,) = jw.values(), tw.values()
        # the switch on alternate rows of faces inside the patch: a face of
        # its end rows meets the corner ghosts of the in/outflow, where a
        # hand-set switch gives NaN in both packages
        mask = np.zeros(np_(jv["low_re"]).shape, dtype=bool)
        mask[1:-1:2] = True
        jv["low_re"] = jnp.asarray(mask)
        tv["low_re"] = torch.as_tensor(mask)
        tp = torch.tensor(np_(jp))         # one input for both
        t_all = ts.phys.temperature(tp[ts.phys.ie], tp[:ts.phys.ns])
        mu_all = ts.phys.viscosity(t_all)
        want = jax.jit(lambda p, t, mu, wall, jb=jb: jvis.viscous_residual(
            js.phys, js.cfg, jb, p, t, mu, wall_data=wall, need_aux=False,
            need_pgrad=True))(jnp.asarray(np_(tp)), jnp.asarray(np_(t_all)),
                              jnp.asarray(np_(mu_all)), jw)
        got = tvis.viscous_residual(ts.phys, ts.cfg, tb, tp, t_all, mu_all,
                                    wall_data=tw, need_pgrad=True)
        for i, what in enumerate(("resid", "sr_flow", "sr_turb",
                                  "diag_flow", "diag_turb")):
            g, w = np_(got[i]), np_(want[i])
            _close(g if g.ndim == 4 else g[None], w if w.ndim == 4
                   else w[None], f"{solver} {what}", RIDDER_TOL)
        for key in ("vel", "press", "tke", "omega", "mut", "f1", "f2"):
            g, w = np_(got[5][key]), np_(want[5][key])
            _close(g.reshape((-1,) + g.shape[-3:]),
                   w.reshape((-1,) + w.shape[-3:]), f"{solver} {key}",
                   RIDDER_TOL)
        if solver == "blusgs":
            for i in (6, 7):       # (ni, nj, nk, N, N), entries first
                g, w = np_(got[i]), np_(want[i])
                _close(np.moveaxis(g.reshape(g.shape[:3] + (-1,)), -1, 0),
                       np.moveaxis(w.reshape(w.shape[:3] + (-1,)), -1, 0),
                       f"block diagonal {i}", RIDDER_TOL)


# ---------------------------------------------------------------------------
# the annular sector: rotational periodic and the supersonic pair on a grid
# that is not the plate


@pytest.fixture(scope="module")
def annular(tmp_path_factory):
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gridgen
    wd = tmp_path_factory.mktemp("annular")
    path = gridgen.make_annular_sector(str(wd))
    js, ts = jax_solver(path, wd, scan=True), torch_solver(path, wd)
    prims = perturbed_prims(js.case.blocks)
    js.prims = {b: jnp.asarray(v) for b, v in prims.items()}
    js.cons_n = js.store_old_solution()
    ts.set_state(prims, {b: np_(v) for b, v in js.cons_n.items()})
    return js, ts


def test_annular_sector_ghosts(annular):
    """the rotational periodic connection of one block with itself and the
    supersonic pair: every ghost after the full fill"""
    from aither_tpu.solver import step as jstep
    from aither_tpu_torch.solver import step as tstep
    js, ts = annular
    assert [c.is_interblock for c in ts.case.connections] == [False]
    want = jax.jit(lambda p: jstep.apply_all_bcs(js.phys, js.case, p))(
        dict(js.prims))
    got = tstep.apply_all_bcs(ts.phys, ts.case, dict(ts.prims))
    for b in want:
        _close(got[b], want[b], f"annular block {b}")


def test_annular_sector_iteration_and_history(annular):
    js, ts = annular
    check_one_iteration(js, ts)
    check_history(js, ts, iterations=3)

