"""PyTorch port, pointwise parity with aither_tpu: physics bundle, state
conversions, fluxes, MUSCL, SST closures and the Rusanov off-diagonal.

Tolerance: rtol 1e-12.  Both sides evaluate the same float64 formulas in
the same operation order; only libm (pow, sqrt, tanh) and XLA's fusion may
round differently, by a few ulp (~1e-15 relative), and no formula here
subtracts nearly equal numbers except the off-diagonal flux change, which
is compared against the scale of its row (see test_offdiagonal_scalar).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (SEED, assert_close, rel_err,  # noqa: E402
                                write_case)

RTOL = 1e-12
N = 64


@pytest.fixture(scope="module")
def phys_pair(tmp_path_factory):
    from aither_tpu.io.deck import parse_deck
    from aither_tpu.physics.models import Physics as JPhysics
    from aither_tpu_torch.physics.models import Physics as TPhysics
    path = write_case(tmp_path_factory.mktemp("plate"))
    deck = parse_deck(path).finalize()
    return JPhysics.from_deck(deck), TPhysics.from_deck(deck)


def _prims(phys, n=N, seed=SEED):
    """random physical primitive states (neq, n) around the plate's
    freestream: rho ~1, |v| ~0.2, p ~0.714, k, omega > 0."""
    rng = np.random.default_rng(seed)
    q = np.empty((phys.neq, n))
    q[0] = 1.0 + 0.2 * rng.random(n)
    q[1:4] = 0.2 * (rng.random((3, n)) - 0.3)
    q[4] = 0.714 * (1.0 + 0.2 * rng.random(n))
    q[5] = 1e-4 * (1.0 + rng.random(n))
    q[6] = 10.0 * (1.0 + rng.random(n))
    return q


def _normals(n=N, seed=SEED + 1):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((3, n))
    return v / np.linalg.norm(v, axis=0)


def test_physics_constants(phys_pair):
    jp, tp = phys_pair
    assert (tp.ns, tp.neq, tp.nturb) == (jp.ns, jp.neq, jp.nturb)
    for name in ("t_ref", "mu_mix_ref", "k_nondim", "nondim_scaling"):
        assert getattr(tp, name) == pytest.approx(getattr(jp, name),
                                                  rel=1e-15), name
    assert tp.R == pytest.approx(jp.R, rel=1e-15)
    assert tp.n == jp.n and tp.hf == jp.hf
    assert tp.turb_prandtl() == jp.turb_prandtl()
    assert tp.turb_min() == jp.turb_min()


@pytest.mark.parametrize("fn", ["temperature", "sos", "enthalpy",
                                "cons_from_prim", "viscosity",
                                "conductivity", "gamma"])
def test_state_pointwise(phys_pair, fn):
    from aither_tpu.solver import state as jst
    from aither_tpu_torch.solver import state as tst
    jp, tp = phys_pair
    q = _prims(tp)
    if fn in ("viscosity", "conductivity", "gamma"):
        t = q[4] / (tp.R * q[0])
        mf = np.ones((1, N))
        want = getattr(jp, fn)(jnp.asarray(t), jnp.asarray(mf))
        got = getattr(tp, fn)(torch.as_tensor(t))
    else:
        want = getattr(jst, fn)(jp, jnp.asarray(q))
        got = getattr(tst, fn)(tp, torch.as_tensor(q))
    assert_close(got, want, RTOL, 0.0, fn)


def test_prim_cons_roundtrip_and_update(phys_pair):
    from aither_tpu.solver import state as jst
    from aither_tpu_torch.solver import state as tst
    jp, tp = phys_pair
    q = _prims(tp)
    rng = np.random.default_rng(SEED + 2)
    cons = np.array(jst.cons_from_prim(jp, jnp.asarray(q)))
    du = 0.01 * (rng.random(cons.shape) - 0.5) * np.abs(cons)
    assert_close(tst.prim_from_cons(tp, torch.as_tensor(cons)),
                 jst.prim_from_cons(jp, jnp.asarray(cons)), RTOL, 0.0,
                 "prim_from_cons")
    assert_close(tst.update_prim_with_cons(tp, torch.as_tensor(q),
                                           torch.as_tensor(du)),
                 jst.update_prim_with_cons(jp, jnp.asarray(q),
                                           jnp.asarray(du)),
                 RTOL, 0.0, "update_prim_with_cons")
    ql, qr = q, _prims(tp, seed=SEED + 3)
    assert_close(tst.roe_average(tp, torch.as_tensor(ql),
                                 torch.as_tensor(qr)),
                 jst.roe_average(jp, jnp.asarray(ql), jnp.asarray(qr)),
                 RTOL, 0.0, "roe_average")


@pytest.mark.parametrize("kind", ["physical", "roe", "rusanov+",
                                  "rusanov-"])
def test_fluxes(phys_pair, kind):
    from aither_tpu.solver import flux as jfl
    from aither_tpu_torch.solver import flux as tfl
    jp, tp = phys_pair
    ql, qr, n = _prims(tp), _prims(tp, seed=SEED + 3), _normals()
    J = [jnp.asarray(a) for a in (ql, qr, n)]
    T = [torch.as_tensor(a) for a in (ql, qr, n)]
    if kind == "physical":
        want = jfl.physical_flux(jp, J[0], J[2])
        got = tfl.physical_flux(tp, T[0], T[2])
    elif kind == "roe":
        want = jfl.roe_flux(jp, *J)
        got = tfl.roe_flux(tp, *T)
    else:
        pos = kind.endswith("+")
        want = jfl.rusanov_flux(jp, *J, pos)
        got = tfl.rusanov_flux(tp, *T, pos)
    # rows are compared against their own scale: the Roe dissipation is a
    # sum of terms of mixed sign
    for e in range(tp.neq):
        assert rel_err(got[e], want[e]) < 1e-13, (kind, e)


@pytest.mark.parametrize("limiter", ["none", "minmod", "vanAlbada"])
def test_muscl_reconstruct_faces(limiter):
    from aither_tpu.solver import reconstruction as jre
    from aither_tpu_torch.solver import reconstruction as tre
    rng = np.random.default_rng(SEED)
    g, n = 2, 9
    prim = 1.0 + 0.1 * rng.random((7, n + 2 * g, 4, 3))
    widths = 0.5 + rng.random((n + 2 * g, 4, 3))
    for scheme in ("constant", "muscl"):
        want = jre.reconstruct_faces(jnp.asarray(prim), jnp.asarray(widths),
                                     1, g, n, scheme, 1.0 / 3.0, limiter)
        got = tre.reconstruct_faces(torch.as_tensor(prim),
                                    torch.as_tensor(widths), 1, g, n, scheme,
                                    1.0 / 3.0, limiter)
        for w, t in zip(want, got):
            assert_close(t, w, RTOL, 0.0, f"{scheme}/{limiter}")
    wl, wr = widths[:-1], widths[1:]
    assert_close(tre.central(torch.as_tensor(prim[:, :-1]),
                             torch.as_tensor(prim[:, 1:]),
                             torch.as_tensor(wl), torch.as_tensor(wr)),
                 jre.central(jnp.asarray(prim[:, :-1]),
                             jnp.asarray(prim[:, 1:]), jnp.asarray(wl),
                             jnp.asarray(wr)), RTOL, 0.0, "central")


def test_sst_closures(phys_pair):
    from aither_tpu.solver import viscous as jvi
    from aither_tpu_torch.solver import viscous as tvi
    jp, tp = phys_pair
    rng = np.random.default_rng(SEED)
    q = _prims(tp)
    vgrad = rng.standard_normal((3, 3, N))
    kgrad = 1e-3 * rng.standard_normal((3, N))
    wgrad = 10.0 * rng.standard_normal((3, N))
    mu = 1.0 + 0.1 * rng.random(N)
    wd = 1e-3 + rng.random(N)
    width = 1e-2 + rng.random(N)
    J = [jnp.asarray(a) for a in (q, vgrad, kgrad, wgrad, mu, wd)]
    T = [torch.as_tensor(a) for a in (q, vgrad, kgrad, wgrad, mu, wd)]
    want = jvi.eddy_visc_and_blending(jp, "sst2003", *J, None)
    got = tvi.eddy_visc_and_blending(tp, "sst2003", *T, None)
    for name, w, t in zip(("mut", "f1", "f2"), want, got):
        assert_close(t, w, RTOL, 0.0, name)
    mut, f1, f2 = want
    want = jvi.turb_source(jp, "sst2003", J[0], J[1], J[2], J[3], mut, f1,
                           f2, jnp.asarray(width))
    got = tvi.turb_source(tp, "sst2003", T[0], T[1], T[2], T[3],
                          torch.as_tensor(np.array(mut)),
                          torch.as_tensor(np.array(f1)),
                          torch.as_tensor(np.array(f2)),
                          torch.as_tensor(width))
    for name, w, t in zip(("src_k", "src_w", "src_rad"), want, got):
        assert rel_err(t, w) < 1e-13, name


@pytest.mark.parametrize("positive", [True, False])
def test_offdiagonal_scalar(phys_pair, positive):
    """The Rusanov off-diagonal product of one neighbour (the sweep's
    per-face arithmetic).  The flux change F(q+du)-F(q) cancels about
    log10(|F|/|dF|) ~ 2 digits, so each row is compared against its own
    scale with 1e-12."""
    from aither_tpu.solver import implicit as jim
    from aither_tpu_torch.solver import implicit as tim
    jp, tp = phys_pair
    rng = np.random.default_rng(SEED + 4)
    q, n = _prims(tp), _normals()
    du = 1e-3 * rng.standard_normal((tp.neq, N))
    mag = 0.5 + rng.random(N)
    dist = 0.01 + rng.random(N)
    mu, mut, f1 = 1.0 + rng.random(N), 10.0 * rng.random(N), rng.random(N)
    cfg = dict(viscous=True, turb_model="sst2003")
    arrays = (q, du, n, mag)
    kws = dict(dist=dist, mu=mu, mut=mut, f1=f1)
    want = jim.offdiagonal_scalar(
        jp, cfg, *(jnp.asarray(a) for a in arrays), positive,
        **{k: jnp.asarray(v) for k, v in kws.items()})
    got = tim.offdiagonal_scalar(
        tp, cfg, *(torch.as_tensor(a) for a in arrays), positive,
        **{k: torch.as_tensor(v) for k, v in kws.items()})
    for e in range(tp.neq):
        assert rel_err(got[e], want[e]) < 1e-12, e
