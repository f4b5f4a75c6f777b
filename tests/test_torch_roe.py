"""PyTorch port, the approximateRoe off-diagonal (``inviscidFluxJacobian:
approximateRoe``) against aither_tpu, whose only path for it is its scan
sweep (it has no Pallas form: ``pallas_sweep.use_pallas`` is False).

Function level (relative 1e-12 per row against its own scale, atol 1e-14:
the same float64 expressions on both sides, libm and XLA's fusion a few
ulp apart): ``roe_offdiagonal`` on random faces for one inviscid species,
SST (viscous, the turbulence rows with the blended sigma_k), Wilcox (sigma*
and the unlimited eddy viscosity) and N2/O2 SST, both sweep sides; at du =
0 the lower form is zero to the roundoff of the update round trip and the
upper one is the side-swap offset mag (F(diag, nb) - F(nb, diag)).

Solver level, SST: the plain Roe sweep pair of the scalar solver without
and of the block solver with the lagged term against the JAX scan sweeps
(1e-10 per equation of its scale, as the Rusanov pairs), the JAX side run
eagerly (``jax.disable_jit``: compiling its Roe scan sweep takes about a
minute a pair) on a 2 x 5x4x2 plate; one whole iteration of lusgs on the
generated plate (1e-10) and a 5-iteration raw L2 history (1e-8), the
tolerances of tests/test_torch_slice.py.  One JAX Solver compiles (its
iteration); the sweep pairs' Solvers compile nothing.  And the Roe forms'
bound (``sweep_cost``: the cell's own state, no velocity gradients).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aither_tpu_torch.cases import N2O2, write_plate_case  # noqa: E402
from tests.torch_parity import (check_history,  # noqa: E402
                                check_one_iteration, check_sweep_pair,
                                jax_solver, np_, solver_pair,
                                sweep_inputs, torch_solver)

RTOL, ATOL = 1e-12, 1e-14
N = 48
ROE = dict(inviscid_flux_jacobian="approximateRoe")

DECKS = {
    "euler": dict(equation_set="euler", turbulence_model="none"),
    "sst": dict(equation_set="rans", turbulence_model="sst2003"),
    "wilcox": dict(equation_set="rans", turbulence_model="kOmegaWilcox2006"),
    "n2o2": dict(equation_set="rans", turbulence_model="sst2003", **N2O2),
}


@pytest.fixture(scope="module")
def physics(tmp_path_factory):
    """{deck name: (JAX Physics, port Physics, JAX cfg, port cfg)} of the
    Roe decks on a 2 x 4x3x2 plate (nothing is run)"""
    out = {}
    for name, deck in DECKS.items():
        wd = tmp_path_factory.mktemp(name)
        path = write_plate_case(str(wd), 4, 3, 2, **deck, **ROE)
        js, ts = jax_solver(path, wd, scan=True), torch_solver(path, wd)
        out[name] = (js.phys, ts.phys, js.cfg, ts.cfg)
    return out


def _state(phys, rng, mf=None):
    """(neq, N) primitive points around the plate's freestream"""
    q = np.empty((phys.neq, N))
    rho = 1.0 + 0.2 * rng.random(N)
    if phys.ns == 1:
        q[0] = rho
    else:
        m = np.asarray(mf)[:, None] * (1.0 + 0.1 * rng.random((phys.ns, N)))
        q[:phys.ns] = rho * m / m.sum(axis=0)
    q[phys.mx:phys.mx + 3] = 0.2 * (rng.random((3, N)) - 0.3)
    q[phys.ie] = 0.714 * (1.0 + 0.2 * rng.random(N))
    if phys.nturb:
        q[phys.it] = 1e-4 * (1.0 + rng.random(N))
        q[phys.it + 1] = 10.0 * (1.0 + rng.random(N))
    return q


def _face(phys, seed, zero_du=False):
    rng = np.random.default_rng(seed)
    mf = N2O2["mass_fractions"] if phys.ns > 1 else None
    n = rng.standard_normal((3, N))
    return dict(
        q_nb=_state(phys, rng, mf), q_diag=_state(phys, rng, mf),
        du_nb=(np.zeros((phys.neq, N)) if zero_du
               else 1e-3 * rng.standard_normal((phys.neq, N))),
        n=n / np.linalg.norm(n, axis=0), mag=0.5 + rng.random(N),
        dist=0.1 + rng.random(N), mu=0.5 + rng.random(N),
        mut=2.0 * rng.random(N), f1=rng.random(N))


def _rows_close(got, want, what):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, what
    for e in range(want.shape[0]):
        np.testing.assert_allclose(got[e], want[e], rtol=RTOL,
                                   atol=ATOL * max(1.0,
                                                   np.abs(want[e]).max()),
                                   err_msg=f"{what} row {e}")


@pytest.mark.parametrize("positive", [True, False])
@pytest.mark.parametrize("name", list(DECKS))
def test_roe_offdiagonal(physics, name, positive):
    from aither_tpu.solver import implicit as jim
    from aither_tpu_torch.solver import implicit as tim
    jp, tp, jc, tc = physics[name]
    a = _face(tp, 11)
    keys = ("dist", "mu", "mut", "f1") if tc["viscous"] else ()
    args = ("q_nb", "q_diag", "du_nb", "n", "mag")
    want = jim.roe_offdiagonal(jp, jc, *(jnp.asarray(a[k]) for k in args),
                               positive, **{k: jnp.asarray(a[k])
                                            for k in keys})
    got = tim.roe_offdiagonal(tp, tc, *(torch.as_tensor(a[k]) for k in args),
                              positive, **{k: torch.as_tensor(a[k])
                                           for k in keys})
    _rows_close(got, want, f"{name} positive={positive}")
    # the dispatch routes approximateRoe to it, scalar and block alike
    for blk in (False, True):
        kw = {k: torch.as_tensor(a[k]) for k in keys}
        via = tim.offdiagonal(tp, dict(tc, block_matrix=blk),
                              torch.as_tensor(a["q_nb"]),
                              torch.as_tensor(a["du_nb"]),
                              torch.as_tensor(a["n"]),
                              torch.as_tensor(a["mag"]), positive,
                              q_diag=torch.as_tensor(a["q_diag"]), **kw)
        assert torch.equal(via, got)


@pytest.mark.parametrize("name", list(DECKS))
def test_roe_offdiagonal_at_zero_update(physics, name):
    """du = 0: the lower form is zero to the roundoff of the update round
    trip, the upper one the side-swap offset, on both sides"""
    from aither_tpu.solver import implicit as jim
    from aither_tpu_torch.solver import implicit as tim
    from aither_tpu_torch.solver.flux import roe_flux
    jp, tp, jc, tc = physics[name]
    a = _face(tp, 5, zero_du=True)
    inviscid = dict(tc, viscous=False)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    lower = tim.roe_offdiagonal(tp, inviscid, t["q_nb"], t["q_diag"],
                                t["du_nb"], t["n"], t["mag"], True)
    flux = roe_flux(tp, t["q_nb"], t["q_diag"], t["n"])
    for e in range(tp.neq):
        scale = float((t["mag"] * flux[e].abs()).max())
        assert float(lower[e].abs().max()) <= 1e-13 * max(scale, 1.0), e
    upper = tim.roe_offdiagonal(tp, inviscid, t["q_nb"], t["q_diag"],
                                t["du_nb"], t["n"], t["mag"], False)
    offset = t["mag"][None] * (roe_flux(tp, t["q_diag"], t["q_nb"], t["n"])
                               - flux)
    _rows_close(upper, offset, f"{name} upper offset")
    want = jim.roe_offdiagonal(jp, dict(jc, viscous=False),
                               *(jnp.asarray(a[k]) for k in
                                 ("q_nb", "q_diag", "du_nb", "n", "mag")),
                               False)
    _rows_close(upper, want, f"{name} upper offset against JAX")


# ---------------------------------------------------------------------------
# solver level, SST on the generated plate


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return solver_pair(tmp_path_factory.mktemp("roe_lusgs"), scan=True,
                       **ROE)


SWEEP_DIMS = (5, 4, 2)


@pytest.mark.parametrize("block,with_extra", [(False, False), (True, True)])
def test_plain_roe_sweep_pair(tmp_path, block, with_extra):
    js, ts = solver_pair(tmp_path, scan=True, dims=SWEEP_DIMS,
                         matrix_solver="blusgs" if block else "lusgs", **ROE)
    assert ts.cfg["inv_flux_jac"] == "approximateRoe"
    assert bool(ts.cfg["block_matrix"]) == block
    with jax.disable_jit():
        check_sweep_pair(js, ts, sweep_inputs(ts), with_extra, scan=True)


def test_one_iteration(pair):
    js, ts = pair
    check_one_iteration(js, ts)


def test_history(pair):
    js, ts = pair
    check_history(js, ts)


@pytest.mark.parametrize("block", [False, True])
def test_sweep_cost_of_roe_forms(tmp_path, block):
    """the Roe form's bound: the Rusanov form's bytes plus the cell's own
    state where no neighbour read brings it, less the block sweep's
    velocity gradients (the Roe form reads none), and its own operations
    per neighbour (ROE_NEIGHBOUR_OPS_BY_FORM, roe_mixture_neighbour_ops),
    the same for the scalar and the block sweep"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    path = write_plate_case(str(tmp_path), 4, 3, 2)
    plan = torch_solver(path, tmp_path).plans[0]
    ncell = int(plan.cells.numel())
    nfaces = int(plan.mask["lower"].sum())
    nread, _ = ls.neighbour_reads(plan, True)
    own = ls.own_reads(plan, True)
    assert 0 < own < ncell
    for form in ((1, 5, False, False), (1, 5, True, False),
                 (1, 7, True, False), (1, 7, True, True),
                 (2, 8, True, False), (5, 9, True, False)):
        ns, neq, viscous, wilcox = form
        rus = ls.sweep_cost(plan, True, False, block, form + (False, False))
        roe = ls.sweep_cost(plan, True, False, block, form + (True, False))
        vgrad = 9 * nread if block and viscous else 0
        assert roe[0] == rus[0] + 8 * (neq * own - vgrad)
        per_nb = (ls.ROE_NEIGHBOUR_OPS_BY_FORM[(neq, viscous, wilcox)]
                  if ns == 1 else
                  ls.roe_mixture_neighbour_ops(form + (True, False)))
        N = ns + 4
        per_cell = (2 * N * N + N + (8 if neq == N + 2 else 0) if block
                    else 2 * neq)
        assert roe[1] == per_nb * nfaces + per_cell * ncell
