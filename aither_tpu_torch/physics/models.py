"""Physics model bundle: static configuration + pointwise torch functions.

Port of ``aither_tpu/physics/models.py`` for the slice the port runs:
one species, calorically perfect ideal gas, Sutherland viscosity and
conductivity.  Arrays are equation-first (``(neq, ...)``), nondimensional,
and ordered ``[rho_s..., u, v, w, p, turb...]`` exactly as in the JAX
package, so the two can be compared array for array.
"""

from __future__ import annotations

import dataclasses

import torch

from ..unsupported import refuse


@dataclasses.dataclass(frozen=True)
class Physics:
    """Static physics configuration (one species, calorically perfect)."""

    ns: int
    neq: int
    n: float                   # DoF/2
    R: float                   # nondim gas constant
    hf: float                  # nondim heat of formation
    visc_c1: float             # Sutherland viscosity (dimensional)
    visc_s: float
    cond_c1: float             # Sutherland conductivity (dimensional)
    cond_s: float
    t_ref: float = 1.0
    mu_mix_ref: float = 1.0
    k_nondim: float = 1.0      # aRef^2 * muMixRef / tRef
    nondim_scaling: float = 1.0  # muMixRef / (rhoRef aRef lRef)
    turb_model: str = "none"

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
    def cv(self) -> float:
        return self.R * self.n

    @property
    def cp(self) -> float:
        return self.R * (self.n + 1.0)

    @property
    def gamma_const(self) -> float:
        return self.cp / self.cv

    # ---- construction ------------------------------------------------------
    @staticmethod
    def from_deck(deck) -> "Physics":
        if deck["thermodynamicModel"] != "caloricallyPerfect":
            refuse("thermallyPerfect")
        if deck.num_species != 1:
            refuse("multispecies")
        if deck["chemistryModel"] != "frozen":
            refuse("chemistry")
        t_ref, r_ref, l_ref, a_ref = (deck.t_ref, deck.r_ref, deck.l_ref,
                                      deck.a_ref)
        raw = deck._fluid_props[0]
        fl = raw.nondimensionalize(t_ref, r_ref, a_ref, l_ref)
        mu_mix_ref = raw.visc_c1 * t_ref ** 1.5 / (t_ref + raw.visc_s)
        return Physics(
            ns=1, neq=deck.num_equations, n=fl.n, R=fl.gas_constant,
            hf=fl.heat_of_formation, visc_c1=raw.visc_c1,
            visc_s=raw.visc_s, cond_c1=raw.cond_c1, cond_s=raw.cond_s,
            t_ref=t_ref, mu_mix_ref=mu_mix_ref,
            k_nondim=a_ref * a_ref * mu_mix_ref / t_ref,
            nondim_scaling=mu_mix_ref / (r_ref * a_ref * l_ref),
            turb_model=deck["turbulenceModel"])

    # ---- thermodynamics (one species: mixture == species) ------------------
    def gamma(self, t, mf=None):
        return torch.full_like(t, self.gamma_const)

    def species_energy(self, t):
        return self.hf + self.cv * t

    def species_enthalpy(self, t):
        return self.hf + self.cp * t

    def temperature_from_energy(self, e, mf=None):
        """(reference: thermodynamic.cpp:101-131, calorically perfect)"""
        return (e - self.hf) / self.cv

    # ---- equation of state (ideal gas) --------------------------------------
    def temperature(self, p, rho_s):
        """T = p / (rho R)  (reference: eos.cpp:96-105)."""
        return p / (self.R * rho_s[0])

    def pressure_rt(self, rho_s, t):
        return self.R * rho_s[0] * t

    def density_tp(self, t, p, mf=None):
        return p / (self.R * t)

    def sos(self, p, rho_s):
        """speed of sound = sqrt(gamma p / rho) (reference: eos.cpp:82-94)."""
        return torch.sqrt(self.gamma_const * p / rho_s[0])

    # ---- transport (Sutherland) ---------------------------------------------
    def viscosity(self, t, mf=None):
        """nondim Sutherland viscosity mu(T*tRef)/muMixRef
        (reference: transport.cpp:103-109)."""
        td = t * self.t_ref
        return (self.visc_c1 * td ** 1.5 / (td + self.visc_s)) \
            / self.mu_mix_ref

    def conductivity(self, t, mf=None):
        """nondim conductivity k(T*tRef)/(aRef^2 muMixRef / tRef)
        (reference: transport.cpp:111-117)."""
        td = t * self.t_ref
        return (self.cond_c1 * td ** 1.5 / (td + self.cond_s)) \
            / self.k_nondim

    def turb_prandtl(self):
        """(reference: turbulence.hpp:70, 462, 578)"""
        return 8.0 / 9.0 if self.turb_model == "kOmegaWilcox2006" else 0.9

    def turb_min(self):
        """minimum allowed turbulence values (reference:
        turbulence.hpp:72-77)."""
        return (1.0e-20, 1.0e-20)


def prandtl(phys: Physics) -> float:
    """laminar Prandtl number 4 gamma / (9 gamma - 5)."""
    g = phys.gamma_const
    return 4.0 * g / (9.0 * g - 5.0)

