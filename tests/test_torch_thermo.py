"""PyTorch port, the thermally perfect gas (``thermodynamicModel:
thermallyPerfect``) of ``physics/models.Physics`` against aither_tpu's
Physics at function level (no Solver compiles): per species cv, cp, the
energy and the enthalpy with their vibrational parts, the mixture's gamma,
Ridder's ``temperature_from_energy`` (with an unbracketed point, which
gives the bracket's top 1e4), the reference entropies s0 with their
vibrational correction and the Gibbs energies of ``chemistry.
gibbs_minimization``; on hot one-species air (``cases.TP_AIR``), N2/O2,
five-species air (``cases.AIR5``, reacting) and a CO2/H2O mixture
(several modes a species: four and three).

Temperatures span 0.3-20 (86-5,760 K) from ``np.random.default_rng``;
the mass fractions are the decks' own perturbed by up to 10%.  T is held
within 1e-12 relative (Ridder's last evaluation point: both sides run the
same iterations, the bracket tests on a few-ulp energy), everything else
within 1e-13 relative to each output row's scale.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aither_tpu_torch import cases  # noqa: E402
from tests.torch_parity import jax_solver, np_, torch_solver  # noqa: E402

RTOL, T_RTOL = 1e-13, 1e-12
N = 48
TP = dict(thermodynamic_model="thermallyPerfect")
DECKS = {
    "air": cases.TP_AIR,
    "n2o2": dict(cases.N2O2, **TP),
    "air5": dict(cases.AIR5, **TP),
    "co2_h2o": dict(species=("CO2", "H2O"), mass_fractions=(0.6, 0.4),
                    **TP),
}


def _close(got, want, rtol, what):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    g = got.reshape(got.shape[0], -1) if got.ndim > 1 else got[None]
    w = want.reshape(want.shape[0], -1) if want.ndim > 1 else want[None]
    scale = np.abs(w).max(axis=1, keepdims=True)
    assert np.all(np.abs(g - w) <= rtol * scale), (
        what, float((np.abs(g - w) / scale).max()))


@pytest.fixture(scope="module")
def physics(tmp_path_factory):
    """{deck: (JAX Physics, port Physics)} of the thermally perfect decks
    on a 2 x 4x3x2 plate (nothing is run); the reacting deck reads its
    mechanism from the working directory"""
    out = {}
    here = os.getcwd()
    for name, deck in DECKS.items():
        wd = tmp_path_factory.mktemp(name)
        path = cases.write_plate_case(str(wd), 4, 3, 2, **deck)
        os.chdir(wd)
        try:
            out[name] = (jax_solver(path, wd).phys,
                         torch_solver(path, wd).phys)
        finally:
            os.chdir(here)
    return out


def _state(name, tp, seed):
    """(T (N,), mass fractions (ns, N)): the deck's mass fractions times
    (1 + 0.1 U[0, 1)), renormalised"""
    rng = np.random.default_rng(seed)
    t = 0.3 + 19.7 * rng.random(N)
    mf0 = np.asarray(DECKS[name].get("mass_fractions", (1.0,)))
    mf = mf0[:, None] * (1.0 + 0.1 * rng.random((tp.ns, N)))
    return t, mf / mf.sum(axis=0)


def _port_mf(tp, mf):
    """the port's mixture argument: None for one species"""
    return None if tp.ns == 1 else torch.as_tensor(mf)


@pytest.mark.parametrize("name", list(DECKS))
def test_model_and_modes(physics, name):
    jp, tp = physics[name]
    assert tp.thermally_perfect and jp.thermo_model == "thermallyPerfect"
    assert tp.vib == jp.vib and any(len(v) > 0 for v in tp.vib)
    if name == "co2_h2o":
        assert [len(v) for v in tp.vib] == [4, 3]


@pytest.mark.parametrize("name", list(DECKS))
def test_species_functions(physics, name):
    jp, tp = physics[name]
    t, _ = _state(name, tp, 1)
    for fn in ("species_cv", "species_cp", "species_energy",
               "species_enthalpy"):
        _close(getattr(tp, fn)(torch.as_tensor(t)),
               getattr(jp, fn)(jnp.asarray(t)), RTOL, f"{name} {fn}")


@pytest.mark.parametrize("name", list(DECKS))
def test_gamma_and_mixture_cp(physics, name):
    jp, tp = physics[name]
    t, mf = _state(name, tp, 2)
    want = jp.gamma(jnp.asarray(t), jnp.asarray(mf))
    _close(tp.gamma(torch.as_tensor(t), _port_mf(tp, mf)), want, RTOL,
           f"{name} gamma")
    want_cp = jp.mix(jp.species_cp(jnp.asarray(t)), jnp.asarray(mf))
    _close(tp.cp(torch.as_tensor(t), _port_mf(tp, mf)), want_cp, RTOL,
           f"{name} cp")


@pytest.mark.parametrize("name", list(DECKS))
def test_temperature_from_energy(physics, name):
    """the energies of known temperatures, plus one above e(1e4) (no sign
    change in the bracket: T = 1e4 on both sides)"""
    jp, tp = physics[name]
    t, mf = _state(name, tp, 3)
    e = np.array(jp.mix(jp.species_energy(jnp.asarray(t)),
                        jnp.asarray(mf)))
    e[0] = 1e9
    want = jp.temperature_from_energy(jnp.asarray(e), jnp.asarray(mf))
    got = tp.temperature_from_energy(torch.as_tensor(e), _port_mf(tp, mf))
    _close(got, want, T_RTOL, f"{name} T")
    assert float(got[0]) == 1.0e4 == float(want[0])
    # the inversion recovers the temperature (Ridder's last point)
    np.testing.assert_allclose(np_(got)[1:], t[1:], rtol=1e-9)
    _, iters = tp._ridder_temperature(torch.as_tensor(e), _port_mf(tp, mf),
                                      count=True)
    assert float(iters[0]) == 0.0 and float(iters[1:].min()) >= 1.0


@pytest.mark.parametrize("name", list(DECKS))
def test_reference_entropy_and_gibbs(physics, name):
    from aither_tpu.physics import chemistry as jchem
    from aither_tpu_torch.physics import chemistry as tchem
    jp, tp = physics[name]
    np.testing.assert_allclose(tp.s0, jp.s0, rtol=RTOL, atol=0.0)
    t, _ = _state(name, tp, 4)
    _close(tchem.gibbs_minimization(tp, torch.as_tensor(t)),
           jchem.gibbs_minimization(jp, jnp.asarray(t)), RTOL,
           f"{name} gibbs")
