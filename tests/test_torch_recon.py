"""PyTorch port, the face reconstructions and the AUSMPW+ flux against
aither_tpu at function level (no Solver compiles): WENO and WENO-Z
(``reconstruction.weno``), the 4-point central reconstruction with and
without its 2-point fallback for the turbulence variables
(``central4``), ``reconstruct_faces`` at three ghost layers on a padded
block, and ``flux.ausm_flux`` for one species, SST and an N2/O2 mixture.

Inputs come from ``np.random.default_rng``: cell widths over a 3:1 range
(a nonuniform grid), states around the plate's freestream perturbed by
up to 20%.  Both sides evaluate the same float64 expressions term by term
in the same order; libm, XLA's fusion and torch's kernels differ by a few
ulp, so every comparison holds 1e-13 relative to each output row's scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aither_tpu_torch.cases import N2O2, write_plate_case  # noqa: E402
from tests.torch_parity import (jax_solver, np_,  # noqa: E402
                                torch_solver)

RTOL = 1e-13
N = 64


def _close(got, want, what):
    """per row of the leading axis: |got - want| <= RTOL max|want row|"""
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    g = got.reshape(got.shape[0], -1) if got.ndim > 1 else got[None]
    w = want.reshape(want.shape[0], -1) if want.ndim > 1 else want[None]
    scale = np.abs(w).max(axis=1, keepdims=True)
    assert np.all(np.abs(g - w) <= RTOL * scale), (
        what, float((np.abs(g - w) / scale).max()))


def _widths(rng, k, shape=(N,)):
    return [0.5 + rng.random(shape) for _ in range(k)]


def _states(rng, k, neq=7, shape=(N,)):
    """k one-species SST states (rho, u, v, w, p, k, omega), each value
    its base times (1 + 0.2 U[0, 1))"""
    base = np.array([1.0, 0.2, 0.01, 0.01, 0.714, 1e-4, 10.0])[:neq]
    base = base.reshape((neq,) + (1,) * len(shape))
    return [base * (1.0 + 0.2 * rng.random((neq,) + shape))
            for _ in range(k)]


@pytest.mark.parametrize("is_weno_z", [False, True])
def test_weno_matches_the_jax_function(is_weno_z):
    from aither_tpu.solver import reconstruction as jrec
    from aither_tpu_torch.solver import reconstruction as trec
    rng = np.random.default_rng(3)
    states, widths = _states(rng, 5), _widths(rng, 5)
    want = jrec.weno(*map(jnp.asarray, states), *map(jnp.asarray, widths),
                     is_weno_z)
    got = trec.weno(*map(torch.as_tensor, states),
                    *map(torch.as_tensor, widths), is_weno_z)
    _close(got, want, f"weno z={is_weno_z}")


@pytest.mark.parametrize("turb_index", [None, 5])
def test_central4_matches_the_jax_function(turb_index):
    from aither_tpu.solver import reconstruction as jrec
    from aither_tpu_torch.solver import reconstruction as trec
    rng = np.random.default_rng(4)
    states, widths = _states(rng, 4), _widths(rng, 4)
    want = jrec.central4(*map(jnp.asarray, states),
                         *map(jnp.asarray, widths), turb_index=turb_index)
    got = trec.central4(*map(torch.as_tensor, states),
                        *map(torch.as_tensor, widths), turb_index=turb_index)
    _close(got, want, f"central4 turb_index={turb_index}")
    if turb_index is not None:
        # the turbulence rows are the 2-point central reconstruction
        two = trec.central(torch.as_tensor(states[1]),
                           torch.as_tensor(states[2]),
                           torch.as_tensor(widths[1]),
                           torch.as_tensor(widths[2]))
        assert torch.equal(got[turb_index:], two[turb_index:])


@pytest.mark.parametrize("scheme", ["weno", "wenoZ"])
def test_reconstruct_faces_at_three_ghost_layers(scheme):
    """every direction of a padded 2 x (6x5x4) block with g = 3"""
    from aither_tpu.solver import reconstruction as jrec
    from aither_tpu_torch.solver import reconstruction as trec
    rng = np.random.default_rng(5)
    g, dims = 3, (6, 5, 4)
    shape = tuple(n + 2 * g for n in dims)
    prim = _states(rng, 1, shape=shape)[0]
    widths = 0.5 + rng.random(shape)
    for axis in (1, 2, 3):
        want = jrec.reconstruct_faces(jnp.asarray(prim), jnp.asarray(widths),
                                      axis, g, dims[axis - 1], scheme, 0.0,
                                      "none")
        got = trec.reconstruct_faces(torch.as_tensor(prim),
                                     torch.as_tensor(widths), axis, g,
                                     dims[axis - 1], scheme, 0.0, "none")
        for side, w, t in zip("lr", want, got):
            assert t.shape[axis] == dims[axis - 1] + 1
            _close(t, w, f"{scheme} axis {axis} {side}")


@pytest.fixture(scope="module")
def physics(tmp_path_factory):
    """{deck: (JAX Physics, port Physics)} of the one-species inviscid, SST
    and N2/O2 SST plates (nothing is run)"""
    out = {}
    for name, deck in (("euler", dict(equation_set="euler",
                                      turbulence_model="none")),
                       ("sst", {}), ("n2o2", N2O2)):
        wd = tmp_path_factory.mktemp(name)
        path = write_plate_case(str(wd), 4, 3, 2, inviscid_flux="ausm",
                                **deck)
        out[name] = (jax_solver(path, wd).phys, torch_solver(path, wd).phys)
    return out


@pytest.mark.parametrize("name", ["euler", "sst", "n2o2"])
def test_ausm_flux_matches_the_jax_function(physics, name):
    """AUSMPW+ on faces across every branch: subsonic and supersonic
    normal Mach numbers of both signs (|M| from 0 to about 2)"""
    from aither_tpu.solver import flux as jflux
    from aither_tpu_torch.solver import flux as tflux
    jp, tp = physics[name]
    rng = np.random.default_rng(6)
    qs = []
    for _ in range(2):
        q = np.empty((tp.neq, N))
        rho = 1.0 + 0.2 * rng.random(N)
        if tp.ns == 1:
            q[0] = rho
        else:
            m = np.array([0.767, 0.233])[:, None] * (
                1.0 + 0.1 * rng.random((2, N)))
            q[:2] = rho * m / m.sum(axis=0)
        q[tp.mx:tp.mx + 3] = 2.0 * (rng.random((3, N)) - 0.5)
        q[tp.ie] = 0.714 * (1.0 + 0.2 * rng.random(N))
        if tp.nturb:
            q[tp.it] = 1e-4 * (1.0 + rng.random(N))
            q[tp.it + 1] = 10.0 * (1.0 + rng.random(N))
        qs.append(q)
    n = rng.standard_normal((3, N))
    n /= np.linalg.norm(n, axis=0)
    want = jflux.inviscid_flux(jp, *map(jnp.asarray, qs), jnp.asarray(n),
                               "ausm")
    got = tflux.inviscid_flux(tp, *map(torch.as_tensor, qs),
                              torch.as_tensor(n), "ausm")
    mach = np.abs((qs[0][tp.mx:tp.mx + 3] * n).sum(axis=0)
                  / np_(tp.sos(torch.as_tensor(qs[0][tp.ie]),
                               torch.as_tensor(qs[0][:tp.ns]))))
    assert mach.min() < 0.3 and mach.max() > 1.0
    _close(got, want, f"ausm {name}")
