"""Primitive/conserved state conversions over equation-first tensors.

Port of ``aither_tpu/solver/state.py``.  Equation ordering matches the
reference varArray map (reference: varArray.hpp:44-103,
primitive.hpp:55-147):
primitive  = [rho_s..., u, v, w, p, turb...]
conserved  = [rho_s..., rho u, rho v, rho w, rho E, rho q...]
"""

from __future__ import annotations

import torch

from ..physics.models import Physics


def rho(phys: Physics, prim):
    return prim[:phys.ns].sum(dim=0)


def velocity(phys: Physics, prim):
    return prim[phys.mx:phys.mx + 3]


def pressure(phys: Physics, prim):
    return prim[phys.ie]


def mass_fractions(phys: Physics, prim):
    return prim[:phys.ns] / rho(phys, prim)


def mixture_fractions(phys: Physics, prim):
    """the mass fractions the Physics mixture functions read (none for one
    species, whose mixture is the species); ``prim`` may also be a
    conserved state: both start with the species densities"""
    return mass_fractions(phys, prim) if phys.ns > 1 else None


def temperature(phys: Physics, prim):
    return phys.temperature(prim[phys.ie], prim[:phys.ns])


def sos(phys: Physics, prim):
    return phys.sos(prim[phys.ie], prim[:phys.ns])


def enthalpy(phys: Physics, prim):
    """total specific enthalpy h0 = h(T) + V^2/2 (reference: eos.cpp:74-80)."""
    t = temperature(phys, prim)
    mf = mixture_fractions(phys, prim)
    vel = velocity(phys, prim)
    return (phys.mix(phys.species_enthalpy(t), mf)
            + 0.5 * (vel * vel).sum(dim=0))


def cons_from_prim(phys: Physics, prim):
    """(reference: primitive.hpp:183-200)"""
    r = rho(phys, prim)
    vel = velocity(phys, prim)
    t = temperature(phys, prim)
    mf = mixture_fractions(phys, prim)
    spec_e = phys.mix(phys.species_energy(t), mf)
    e_total = spec_e + 0.5 * (vel * vel).sum(dim=0)
    parts = [prim[:phys.ns], r[None] * vel, (r * e_total)[None]]
    if phys.nturb:
        parts.append(r[None] * prim[phys.it:])
    return torch.cat(parts, dim=0)


def prim_from_cons(phys: Physics, cons):
    """(reference: primitive.hpp:151-177)"""
    rho_s = cons[:phys.ns]
    r = rho_s.sum(dim=0)
    vel = cons[phys.mx:phys.mx + 3] / r[None]
    spec_e = cons[phys.ie] / r - 0.5 * (vel * vel).sum(dim=0)
    mf = mixture_fractions(phys, cons)
    t = phys.temperature_from_energy(spec_e, mf)
    p = phys.pressure_rt(rho_s, t)
    parts = [rho_s, vel, p[None]]
    if phys.nturb:
        turb = cons[phys.it:] / r[None]
        tmin = phys.turb_min()
        parts += [torch.clamp(turb[i], min=tmin[i])[None]
                  for i in range(phys.nturb)]
    return torch.cat(parts, dim=0)


def update_prim_with_cons(phys: Physics, prim, du):
    """Implicit update: prim -> cons, add du, renormalize species, back to
    prim (reference: primitive.hpp:205-231)."""
    cons = cons_from_prim(phys, prim) + du
    r = cons[:phys.ns].sum(dim=0)
    mf = torch.clamp(cons[:phys.ns] / r[None], min=0.0)
    mf = mf / mf.sum(dim=0)[None]
    cons = torch.cat([r[None] * mf, cons[phys.ns:]], dim=0)
    return prim_from_cons(phys, cons)


def roe_average(phys: Physics, left, right):
    """Roe-averaged primitive state (reference: primitive.hpp:244-280)."""
    rho_l = rho(phys, left)
    rho_r = rho(phys, right)
    ratio = torch.sqrt(rho_r / rho_l)
    coef = 1.0 / (1.0 + ratio)
    rho_s = left[:phys.ns] * ratio[None]
    rest = (left[phys.ns:] + ratio[None] * right[phys.ns:]) * coef[None]
    return torch.cat([rho_s, rest], dim=0)
