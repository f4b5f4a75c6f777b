"""Physics model bundle: static configuration + pointwise torch functions.

Port of ``aither_tpu/physics/models.py:50-393`` for calorically perfect
gases: any number of species, Sutherland viscosity and conductivity per
species with Wilke's mixing rule, species diffusion settings and the
reacting-chemistry configuration (``physics/chemistry.py``).  The
thermally perfect model (its Ridder temperature inversion) is refused.
Arrays are equation-first (``(neq, ...)``), nondimensional, and ordered
``[rho_s..., u, v, w, p, turb...]`` exactly as in the JAX package, so the
two can be compared array for array.

The mixture functions take the mass fractions ``mf`` (ns, ...).  With one
species the mixture is the species: ``mf`` is 1 exactly (rho_s / rho with
rho = rho_s), may be left out, and each function takes the species' own
formula, the JAX package's values without the launches of its species
sums.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import torch

from ..unsupported import refuse
from . import chemistry as _chem


def _mole_fractions_py(molar_mass, mf):
    moles = [m / mm for m, mm in zip(mf, molar_mass)]
    tot = sum(moles)
    return [m / tot for m in moles]


def _wilke_visc_py(mu, molar_mass, x):
    """host-side Wilke mix (reference: transport.cpp:72-93)"""
    mix = 0.0
    ns = len(mu)
    for i in range(ns):
        denom = 0.0
        for j in range(ns):
            denom += x[j] / math.sqrt(1.0 + molar_mass[i] / molar_mass[j]) * (
                1.0 + math.sqrt(mu[i] / mu[j])
                * (molar_mass[j] / molar_mass[i]) ** 0.25) ** 2
        mix += x[i] * mu[i] / denom
    return 4.0 / math.sqrt(2.0) * mix


@dataclasses.dataclass(frozen=True)
class Physics:
    """Static physics configuration (calorically perfect); per-species
    values are nondimensional tuples in species order."""

    ns: int
    neq: int
    n: tuple                          # DoF/2 per species
    R: tuple                          # nondim gas constant per species
    hf: tuple                         # nondim heat of formation per species
    s0: tuple = ()                    # nondim reference entropy per species
    vib: tuple = ()                   # nondim vibrational temperatures
    # Sutherland coefficients (dimensional); nondim viscosity is
    # mu(T*tRef)/muMixRef (reference: transport.cpp:29-66,103-117)
    visc_c1: tuple = ()
    visc_s: tuple = ()
    cond_c1: tuple = ()
    cond_s: tuple = ()
    molar_mass: tuple = ()            # dimensional molar masses (Wilke)
    t_ref: float = 1.0
    mu_mix_ref: float = 1.0           # Wilke mix viscosity at tRef
    k_nondim: float = 1.0             # aRef^2 * muMixRef / tRef
    nondim_scaling: float = 1.0       # muMixRef / (rhoRef aRef lRef)
    turb_model: str = "none"
    diffusion_model: str = "none"
    schmidt: float = 0.9
    chem_model: str = "frozen"
    freezing_temperature: float = 0.0
    chemistry: Any = None             # chemistry.Chemistry (reacting)

    # ---- index helpers ------------------------------------------------------
    @property
    def mx(self):
        return self.ns

    @property
    def my(self):
        return self.ns + 1

    @property
    def mz(self):
        return self.ns + 2

    @property
    def ie(self):
        return self.ns + 3

    @property
    def it(self):
        return self.ns + 4

    @property
    def nturb(self):
        return self.neq - self.ns - 4

    @property
    def is_rans(self):
        return self.nturb > 0

    # ---- per-species constants (host floats) --------------------------------
    @property
    def cv_s(self) -> tuple:
        return tuple(r * n for r, n in zip(self.R, self.n))

    @property
    def cp_s(self) -> tuple:
        return tuple(r * (n + 1.0) for r, n in zip(self.R, self.n))

    # ---- construction ------------------------------------------------------
    @staticmethod
    def from_deck(deck) -> "Physics":
        if deck["thermodynamicModel"] != "caloricallyPerfect":
            refuse("thermallyPerfect")
        t_ref, r_ref, l_ref, a_ref = (deck.t_ref, deck.r_ref, deck.l_ref,
                                      deck.a_ref)
        fluids = [f.nondimensionalize(t_ref, r_ref, a_ref, l_ref)
                  for f in deck._fluid_props]
        # reference entropy of the cpg model (thermodynamic.cpp:27-57)
        s0 = tuple(fl.ref_s - fl.gas_constant * (fl.n + 1.0)
                   * math.log(fl.ref_t) for fl in fluids)
        # dimensional species viscosities at tRef, Wilke-mixed over the
        # reference mixture (reference: transport.cpp:29-66)
        raw = deck._fluid_props
        mu_spec_ref = [f.visc_c1 * t_ref ** 1.5 / (t_ref + f.visc_s)
                       for f in raw]
        if len(raw) == 1:
            mu_mix_ref = mu_spec_ref[0]
        else:
            x = _mole_fractions_py([f.molar_mass for f in raw],
                                   deck.mixture_ref)
            mu_mix_ref = _wilke_visc_py(mu_spec_ref,
                                        [f.molar_mass for f in raw], x)
        return Physics(
            ns=deck.num_species, neq=deck.num_equations,
            n=tuple(f.n for f in fluids),
            R=tuple(f.gas_constant for f in fluids),
            hf=tuple(f.heat_of_formation for f in fluids), s0=s0,
            vib=tuple(f.vib_temps for f in fluids),
            visc_c1=tuple(f.visc_c1 for f in raw),
            visc_s=tuple(f.visc_s for f in raw),
            cond_c1=tuple(f.cond_c1 for f in raw),
            cond_s=tuple(f.cond_s for f in raw),
            molar_mass=tuple(f.molar_mass for f in raw),
            t_ref=t_ref, mu_mix_ref=mu_mix_ref,
            k_nondim=a_ref * a_ref * mu_mix_ref / t_ref,
            nondim_scaling=mu_mix_ref / (r_ref * a_ref * l_ref),
            turb_model=deck["turbulenceModel"],
            diffusion_model=deck["diffusionModel"],
            schmidt=deck["schmidtNumber"],
            chem_model=deck["chemistryModel"],
            freezing_temperature=deck["freezingTemperature"],
            chemistry=_chem.from_deck(deck, search_dirs=(os.getcwd(),)))

    # ---- species sums with scalar coefficients ------------------------------
    def _sum_species(self, coeffs, arr):
        """sum_i coeffs[i] * arr[i], in species order from 0.0 (the JAX
        package's order)."""
        out = 0.0
        for i in range(self.ns):
            out = out + float(coeffs[i]) * arr[i]
        return out

    def _stack_species(self, fn):
        return torch.stack([fn(i) for i in range(self.ns)])

    # ---- thermodynamics ------------------------------------------------------
    def species_cv(self, t):
        """cv per species at temperature t: (ns, *t.shape)."""
        if self.ns == 1:
            return torch.full_like(t, self.cv_s[0])[None]
        ones = torch.ones_like(t)
        return self._stack_species(lambda i: self.cv_s[i] * ones)

    def species_cp(self, t):
        if self.ns == 1:
            return torch.full_like(t, self.cp_s[0])[None]
        ones = torch.ones_like(t)
        return self._stack_species(lambda i: self.cp_s[i] * ones)

    def species_energy(self, t):
        """specific internal energy per species (thermodynamic.hpp:102-104)"""
        if self.ns == 1:
            return (self.hf[0] + self.cv_s[0] * t)[None]
        cv = self.species_cv(t)
        return self._stack_species(lambda i: self.hf[i] + cv[i] * t)

    def species_enthalpy(self, t):
        if self.ns == 1:
            return (self.hf[0] + self.cp_s[0] * t)[None]
        return self._stack_species(
            lambda i: self.hf[i] + self.R[i] * (self.n[i] + 1.0) * t)

    def mix(self, per_species, mf=None):
        if self.ns == 1:
            return per_species[0]
        return (per_species * mf).sum(dim=0)

    def gamma(self, t, mf=None):
        if self.ns == 1:
            return torch.full_like(t, self.cp_s[0] / self.cv_s[0])
        return (self.mix(self.species_cp(t), mf)
                / self.mix(self.species_cv(t), mf))

    def cp(self, t, mf=None):
        """cp of the mixture at (t, mf): a float for one species"""
        if self.ns == 1:
            return self.cp_s[0]
        return self.mix(self.species_cp(t), mf)

    def temperature_from_energy(self, e, mf=None):
        """(reference: thermodynamic.cpp:101-131, calorically perfect)"""
        if self.ns == 1:
            return (e - self.hf[0]) / self.cv_s[0]
        return ((e - self._sum_species(self.hf, mf))
                / self._sum_species(self.cv_s, mf))

    # ---- equation of state (ideal gas) --------------------------------------
    def temperature(self, p, rho_s):
        """T = p / sum(rho_s R_s)  (reference: eos.cpp:96-105)."""
        if self.ns == 1:
            return p / (self.R[0] * rho_s[0])
        return p / self._sum_species(self.R, rho_s)

    def pressure_rt(self, rho_s, t):
        if self.ns == 1:
            return self.R[0] * rho_s[0] * t
        return self._sum_species(self.R, rho_s) * t

    def density_tp(self, t, p, mf=None):
        if self.ns == 1:
            return p / (self.R[0] * t)
        return p / (self._sum_species(self.R, mf) * t)

    def sos(self, p, rho_s):
        """speed of sound = sqrt(gamma p / rho) (reference: eos.cpp:82-94)."""
        if self.ns == 1:
            return torch.sqrt(self.cp_s[0] / self.cv_s[0] * p / rho_s[0])
        rho = rho_s.sum(dim=0)
        mf = rho_s / rho
        t = self.temperature(p, rho_s)
        return torch.sqrt(self.gamma(t, mf) * p / rho)

    # ---- transport (Sutherland + Wilke mixing) -------------------------------
    def species_viscosity(self, t):
        """nondim Sutherland viscosity per species: mu(T*tRef)/muMixRef
        (reference: transport.cpp:103-109)."""
        td = t * self.t_ref
        return self._stack_species(
            lambda i: (self.visc_c1[i] * td ** 1.5
                       / (td + self.visc_s[i])) / self.mu_mix_ref)

    def species_conductivity(self, t):
        """nondim conductivity: k(T*tRef)/(aRef^2 muMixRef / tRef)
        (reference: transport.cpp:111-117)."""
        td = t * self.t_ref
        return self._stack_species(
            lambda i: (self.cond_c1[i] * td ** 1.5
                       / (td + self.cond_s[i])) / self.k_nondim)

    def mole_fractions(self, mf):
        moles = self._stack_species(lambda i: mf[i] / self.molar_mass[i])
        return moles / moles.sum(dim=0)

    def viscosity(self, t, mf=None):
        """Wilke's mixing rule for viscosity (transport.cpp:72-93)."""
        if self.ns == 1:
            td = t * self.t_ref
            return (self.visc_c1[0] * td ** 1.5
                    / (td + self.visc_s[0])) / self.mu_mix_ref
        mu = self.species_viscosity(t)
        x = self.mole_fractions(mf)
        mm = self.molar_mass
        mix = torch.zeros_like(t)
        for i in range(self.ns):
            denom = torch.zeros_like(t)
            for j in range(self.ns):
                denom = denom + x[j] / math.sqrt(1.0 + mm[i] / mm[j]) * (
                    1.0 + torch.sqrt(mu[i] / mu[j])
                    * (mm[j] / mm[i]) ** 0.25) ** 2
            mix = mix + x[i] * mu[i] / denom
        return 4.0 / math.sqrt(2.0) * mix

    def conductivity(self, t, mf=None):
        """0.5*(weighted + harmonic mole-fraction average)
        (transport.cpp:95-106)."""
        if self.ns == 1:
            td = t * self.t_ref
            return (self.cond_c1[0] * td ** 1.5
                    / (td + self.cond_s[0])) / self.k_nondim
        k = self.species_conductivity(t)
        x = self.mole_fractions(mf)
        weighted = (x * k).sum(dim=0)
        harmonic = 1.0 / (x / k).sum(dim=0)
        return 0.5 * (weighted + harmonic)

    def effective_conductivity(self, t, mf=None):
        return self.nondim_scaling * self.conductivity(t, mf)

    def turb_prandtl(self):
        """(reference: turbulence.hpp:70, 462, 578)"""
        return 8.0 / 9.0 if self.turb_model == "kOmegaWilcox2006" else 0.9

    def turb_min(self):
        """minimum allowed turbulence values (reference:
        turbulence.hpp:72-77)."""
        return (1.0e-20, 1.0e-20)


def prandtl(phys: Physics, t, mf=None):
    """laminar Prandtl number 4 gamma / (9 gamma - 5) of the mixture at
    (t, mf) (the JAX package's implicit._prandtl); a float for one
    species"""
    g = (phys.cp_s[0] / phys.cv_s[0] if phys.ns == 1
         else phys.gamma(t, mf))
    return 4.0 * g / (9.0 * g - 5.0)
