"""PyTorch port, residual and linear-system parity with aither_tpu on the
generated two-block SST plate (perturbed state): inviscid residual, the
full viscous + SST residual with its spectral radii, diagonal terms and
aux fields, local time step, diagonal, rhs and the matrix residual.

Tolerance: the residual of a near-uniform flow is a difference of face
fluxes that cancel about 3-4 digits, so each field is compared against
its own scale (max |want|) at 1e-10: float64 roundoff (1e-16) amplified
by that cancellation and by the limiter's ratio r, which is a quotient of
two such differences.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (jax_solver, perturbed_prims,  # noqa: E402
                                rel_err, torch_solver, write_case)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

TOL = 1e-10


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    wd = tmp_path_factory.mktemp("plate")
    path = write_case(wd)
    return jax_solver(path, wd), torch_solver(path, wd)


def _jax_linear(js, prims, cfl):
    """The first half of aither_tpu's Solver._iteration plus its
    _setup_linear, for comparison field by field."""
    from aither_tpu.solver import implicit as jim
    from aither_tpu.solver import step as jstep
    phys, case, cfg = js.phys, js.case, js.cfg
    prims = jstep.apply_all_bcs(phys, case, prims)
    out = {}
    auxs = {}
    for b in case.blocks:
        inv = jstep.inviscid_residual(phys, cfg, b, prims[b.index])
        (resid, sr_f, sr_t, dg_f, dg_t, _, prim_v,
         aux) = jstep.full_residual(phys, cfg, b, prims[b.index],
                                    need_aux=False)
        sr_max = jnp.maximum(sr_f, sr_t)
        dt = jstep.local_dt(cfg, b.geom, sr_max, b.g, (b.ni, b.nj, b.nk),
                            cfl)
        auxs[b.index] = aux
        out[b.index] = dict(inv_resid=inv[0], inv_sr=inv[1], inv_srt=inv[2],
                            resid=resid, sr_f=sr_f, sr_t=sr_t, dg_f=dg_f,
                            dg_t=dg_t, prim=prim_v, dt=dt, mu=aux["mu"],
                            sr_max=sr_max)
    for key in ("mut", "f1"):
        field = {bi: auxs[bi][key][None] for bi in auxs}
        for conn in case.connections:
            field = jstep.swap_connection_states(phys, case.blocks, field,
                                                 conn, case.blocks[0].g)
        for bi in auxs:
            out[bi][key] = field[bi][0]
    cons_n = js.store_old_solution()
    for b in case.blocks:
        o = out[b.index]
        o["inv_f"], o["inv_t"] = jim.build_diagonal(
            phys, b, cfg, o["dg_f"], o["dg_t"], o["sr_max"], o["dt"])
        o["b"] = jim.rhs_b(phys, b, cfg, o["prim"], o["resid"],
                           cons_n[b.index], 0.0, o["dt"])
    return out


def test_residual_and_linear_setup(pair):
    from aither_tpu_torch.solver import step as tstep
    js, ts = pair
    prims = perturbed_prims(js.case.blocks)
    cfl = js.deck.cfl(0)
    js.prims = {b: jnp.asarray(v) for b, v in prims.items()}
    want = jax.jit(lambda p: _jax_linear(js, p, cfl))(js.prims)

    ts.set_state(prims)
    tprims, res, sr, dg, dts, auxs = ts._residuals(dict(ts.prims), cfl)
    inv_diag, _, bs, _ = ts._setup_linear(tprims, res, sr, dg, dts, auxs,
                                          ts.cons_n)
    for b in ts.case.blocks:
        bi = b.index
        w = want[bi]
        inv = tstep.inviscid_residual(ts.phys, ts.cfg, b,
                                      tstep.apply_all_bcs(
                                          ts.phys, ts.case,
                                          dict(ts.prims))[bi])
        got = dict(inv_resid=inv[0], inv_sr=inv[1], inv_srt=inv[2],
                   resid=res[bi], sr_max=sr[bi], dg_f=dg[bi][0],
                   dg_t=dg[bi][1], prim=tprims[bi], dt=dts[bi],
                   mu=auxs[bi]["mu"], mut=auxs[bi]["mut"],
                   f1=auxs[bi]["f1"], inv_f=inv_diag[bi][0],
                   inv_t=inv_diag[bi][1], b=bs[bi])
        for key, g in got.items():
            if key in ("inv_resid", "resid", "b"):
                for e in range(g.shape[0]):      # per equation scale
                    err = rel_err(g[e], w[key][e])
                    assert err < TOL, (bi, key, e, err)
            else:
                err = rel_err(g, w[key])
                assert err < TOL, (bi, key, err)


def test_matrix_residual(pair):
    """-(A x - b) with the lower and upper off-diagonal sums, for a random
    du (ghosts included, so connection contributions act)."""
    from aither_tpu.solver import implicit as jim
    from aither_tpu_torch.solver import implicit as tim
    js, ts = pair
    prims = perturbed_prims(js.case.blocks)
    ts.set_state(prims)
    cfl = ts.deck.cfl(0)
    tprims, res, sr, dg, dts, auxs = ts._residuals(dict(ts.prims), cfl)
    _, a_diag, bs, _ = ts._setup_linear(tprims, res, sr, dg, dts, auxs,
                                        ts.cons_n)
    rng = np.random.default_rng(11)
    for b, jb in zip(ts.case.blocks, js.case.blocks):
        bi = b.index
        du = 1e-3 * rng.standard_normal((ts.phys.neq,) + b.shape)
        got = tim.matrix_residual(ts.phys, ts.cfg, b, tprims[bi],
                                  torch.as_tensor(du), bs[bi], *a_diag[bi],
                                  aux=auxs[bi])
        j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
        jaux = {k: j(auxs[bi][k]) for k in ("mu", "mut", "f1")}
        ctx = jim.build_implicit_context(jb)
        want = jax.jit(lambda p, d, bb, af, at, ax: jim.matrix_residual(
            js.phys, js.cfg, jb, ctx, p, d, bb, af, at, aux=ax))(
                j(tprims[bi]), jnp.asarray(du), j(bs[bi]),
                j(a_diag[bi][0]), j(a_diag[bi][1]), jaux)
        for e in range(ts.phys.neq):
            err = rel_err(got[e], want[e])
            assert err < TOL, (bi, e, err)
