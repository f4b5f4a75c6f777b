"""Physics model bundle: static configuration + pointwise torch functions.

Port of ``aither_tpu/physics/models.py:50-393``: calorically and
thermally perfect gases (the vibrational terms and Ridder's temperature
inversion of the latter), any number of species, Sutherland viscosity and
conductivity per species with Wilke's mixing rule, species diffusion
settings and the reacting-chemistry configuration
(``physics/chemistry.py``).  Arrays are equation-first (``(neq, ...)``),
nondimensional, and ordered ``[rho_s..., u, v, w, p, turb...]`` exactly as in the JAX package, so the
two can be compared array for array.

The mixture functions take the mass fractions ``mf`` (ns, ...).  With one
species the mixture is the species: ``mf`` is 1 exactly (rho_s / rho with
rho = rho_s), may be left out, and each function takes the species' own
formula, the JAX package's values without the launches of its species
sums.  A thermally perfect gas reads its cv, cp and gamma as functions of
T on those paths too (``thermally_perfect``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import torch

from . import chemistry as _chem

# Ridder's temperature inversion of a thermally perfect gas: the bracket,
# the tolerance on its width and the iteration count (reference:
# thermodynamic.cpp:132-141, utility.hpp:130-184)
RIDDER_LO, RIDDER_HI, RIDDER_TOL, RIDDER_ITERS = 1.0e-8, 1.0e4, 1.0e-8, 64


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
    """Static physics configuration; per-species values are
    nondimensional tuples in species order."""

    ns: int
    neq: int
    thermo_model: str                 # caloricallyPerfect | thermallyPerfect
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

    @property
    def thermally_perfect(self) -> bool:
        return self.thermo_model == "thermallyPerfect"

    # ---- per-species constants (host floats) --------------------------------
    # the calorically perfect cv and cp; a thermally perfect gas adds its
    # vibrational part, a function of T (species_cv, species_cp)
    @property
    def cv_s(self) -> tuple:
        return tuple(r * n for r, n in zip(self.R, self.n))

    @property
    def cp_s(self) -> tuple:
        return tuple(r * (n + 1.0) for r, n in zip(self.R, self.n))

    # ---- construction ------------------------------------------------------
    @staticmethod
    def from_deck(deck) -> "Physics":
        t_ref, r_ref, l_ref, a_ref = (deck.t_ref, deck.r_ref, deck.l_ref,
                                      deck.a_ref)
        fluids = [f.nondimensionalize(t_ref, r_ref, a_ref, l_ref)
                  for f in deck._fluid_props]
        thermo_model = deck["thermodynamicModel"]
        # reference entropy of the cpg model (thermodynamic.cpp:27-57)
        s0 = []
        for fl in fluids:
            v = fl.ref_s - fl.gas_constant * (fl.n + 1.0) * math.log(fl.ref_t)
            if thermo_model == "thermallyPerfect":
                # the reference subtracts the raw vibrational sum, not
                # scaled by R (thermodynamic.cpp:50-57): kept for the
                # Gibbs energies' parity
                for tv in fl.vib_temps:
                    v -= (tv / ((math.exp(tv / fl.ref_t) - 1.0) * fl.ref_t)
                          - math.log(1.0 - math.exp(-tv / fl.ref_t)))
            s0.append(v)
        s0 = tuple(s0)
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
            thermo_model=thermo_model, n=tuple(f.n for f in fluids),
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
    def _vib_cpcv(self, t):
        """per species the sum over its vibrational modes of
        (tv / sinh(tv))^2, tv = theta / (2 T), in the fluid table's order
        (reference: thermodynamic.hpp:129-140)"""
        out = []
        for ss in range(self.ns):
            acc = torch.zeros_like(t)
            for theta in self.vib[ss]:
                tv = theta / (2.0 * t)
                acc = acc + (tv / torch.sinh(tv)) ** 2
            out.append(acc)
        return out

    def _vib_energy(self, t):
        """per species the sum over its modes of theta / (exp(theta / T) -
        1) (reference: thermodynamic.hpp:142-148)"""
        out = []
        for ss in range(self.ns):
            acc = torch.zeros_like(t)
            for theta in self.vib[ss]:
                acc = acc + theta / (torch.exp(theta / t) - 1.0)
            out.append(acc)
        return out

    def species_cv(self, t):
        """cv per species at temperature t: (ns, *t.shape)."""
        if self.thermally_perfect:
            ones, vib = torch.ones_like(t), self._vib_cpcv(t)
            return self._stack_species(
                lambda i: self.R[i] * self.n[i] * ones + self.R[i] * vib[i])
        if self.ns == 1:
            return torch.full_like(t, self.cv_s[0])[None]
        ones = torch.ones_like(t)
        return self._stack_species(lambda i: self.cv_s[i] * ones)

    def species_cp(self, t):
        if self.thermally_perfect:
            ones, vib = torch.ones_like(t), self._vib_cpcv(t)
            return self._stack_species(
                lambda i: self.R[i] * (self.n[i] + 1.0) * ones
                + self.R[i] * vib[i])
        if self.ns == 1:
            return torch.full_like(t, self.cp_s[0])[None]
        ones = torch.ones_like(t)
        return self._stack_species(lambda i: self.cp_s[i] * ones)

    def species_energy(self, t):
        """specific internal energy per species (thermodynamic.hpp:102-104,
        163-166)"""
        if self.thermally_perfect:
            # the calorically perfect cv part plus the vibrational energy
            vib = self._vib_energy(t)
            return self._stack_species(
                lambda i: self.hf[i] + self.R[i] * self.n[i] * t
                + self.R[i] * vib[i])
        if self.ns == 1:
            return (self.hf[0] + self.cv_s[0] * t)[None]
        cv = self.species_cv(t)
        return self._stack_species(lambda i: self.hf[i] + cv[i] * t)

    def species_enthalpy(self, t):
        if self.thermally_perfect:
            vib = self._vib_energy(t)
            return self._stack_species(
                lambda i: self.hf[i] + self.R[i] * (self.n[i] + 1.0) * t
                + self.R[i] * vib[i])
        if self.ns == 1:
            return (self.hf[0] + self.cp_s[0] * t)[None]
        return self._stack_species(
            lambda i: self.hf[i] + self.R[i] * (self.n[i] + 1.0) * t)

    def mix(self, per_species, mf=None):
        if self.ns == 1:
            return per_species[0]
        return (per_species * mf).sum(dim=0)

    def gamma(self, t, mf=None):
        if self.ns == 1 and not self.thermally_perfect:
            return torch.full_like(t, self.cp_s[0] / self.cv_s[0])
        return (self.mix(self.species_cp(t), mf)
                / self.mix(self.species_cv(t), mf))

    def cp(self, t, mf=None):
        """cp of the mixture at (t, mf): a float for one calorically
        perfect species"""
        if self.ns == 1 and not self.thermally_perfect:
            return self.cp_s[0]
        return self.mix(self.species_cp(t), mf)

    def temperature_from_energy(self, e, mf=None):
        """Invert e(T, mf) for T (reference: thermodynamic.cpp:101-141)."""
        if self.thermally_perfect:
            return self._ridder_temperature(e, mf)[0]
        if self.ns == 1:
            return (e - self.hf[0]) / self.cv_s[0]
        return ((e - self._sum_species(self.hf, mf))
                / self._sum_species(self.cv_s, mf))

    def _ridder_temperature(self, e, mf=None, count=False):
        """(T, iterations): Ridder's method on [RIDDER_LO, RIDDER_HI] at
        RIDDER_TOL, T the final evaluation point x4, as the reference and
        the JAX package (reference: utility.hpp:130-184; aither_tpu
        models.py:263-306): RIDDER_ITERS iterations, each point frozen once
        its bracket is within the tolerance or a residual is exactly 0; an
        unbracketed point gives RIDDER_HI.  A frozen point never changes
        again, so the loop stops once every point is frozen.  With
        ``count``, ``iterations`` (e.shape) counts each point's iterations
        up to and including the one that froze it; else it is None."""
        def fres(t):
            return e - self.mix(self.species_energy(t), mf)

        x1 = torch.full_like(e, RIDDER_LO)
        x2 = torch.full_like(e, RIDDER_HI)
        f1 = fres(x1)
        f2 = fres(x2)
        bracketed = torch.sign(f1) != torch.sign(f2)
        x4 = torch.full_like(e, RIDDER_HI)
        done = ~bracketed
        iters = torch.zeros_like(e) if count else None
        for _ in range(RIDDER_ITERS):
            if bool(done.all()):
                break
            if count:
                iters = iters + (~done).to(e.dtype)
            x3 = 0.5 * (x1 + x2)
            f3 = fres(x3)
            denom = torch.sqrt(torch.abs(f3 * f3 - f1 * f2)) + 1.0e-300
            x4n = x3 + (x3 - x1) * (torch.sign(f1 - f2) * f3) / denom
            f4 = fres(x4n)
            x4 = torch.where(done, x4, x4n)
            c1 = torch.sign(f4) != torch.sign(f3)
            c2 = torch.sign(f4) != torch.sign(f1)
            nx1 = torch.where(c1, x3, torch.where(c2, x1, x4n))
            nf1 = torch.where(c1, f3, torch.where(c2, f1, f4))
            nx2 = torch.where(c1, x4n, torch.where(c2, x4n, x2))
            nf2 = torch.where(c1, f4, torch.where(c2, f4, f2))
            x1 = torch.where(done, x1, nx1)
            f1 = torch.where(done, f1, nf1)
            x2 = torch.where(done, x2, nx2)
            f2 = torch.where(done, f2, nf2)
            done = (done | (torch.abs(x2 - x1) <= RIDDER_TOL) | (f3 == 0.0)
                    | (f4 == 0.0))
        return torch.where(bracketed, x4, RIDDER_HI), iters

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
            if self.thermally_perfect:
                t = self.temperature(p, rho_s)
                return torch.sqrt(self.gamma(t) * p / rho_s[0])
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
    calorically perfect species"""
    g = (phys.cp_s[0] / phys.cv_s[0]
         if phys.ns == 1 and not phys.thermally_perfect
         else phys.gamma(t, mf))
    return 4.0 * g / (9.0 * g - 5.0)
