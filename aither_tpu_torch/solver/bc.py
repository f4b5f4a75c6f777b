"""Boundary-condition ghost states over boundary patches.

Port of ``aither_tpu/solver/bc.py``: every boundary type of the JAX
package (reference: src/ghostStates.cpp:60-707): slipWall, characteristic,
inlet (reflecting or LODI nonreflecting), supersonicInflow,
supersonicOutflow, stagnationInlet, pressureOutlet (reflecting or LODI
nonreflecting) and viscousWall (low-Re or the wall law; isothermal,
constant heat flux or adiabatic), plus the ``ghost_state`` dispatch, for
any species count: boundary states carry their mass fractions, the
viscous wall keeps the interior's.  Each function maps (interior patch
state, outward unit normal, static BC data) -> ghost patch state; the
periodic and interblock faces are connections, filled by the swap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..physics.models import Physics
from . import state as st
from . import wall_law
from .viscous import wall_beta


@dataclasses.dataclass(frozen=True)
class BCData:
    """Nondimensional boundary-state data (from the deck's boundaryStates)."""

    tag: int = -1
    velocity: tuple = (0.0, 0.0, 0.0)
    density: float = 0.0
    pressure: float = 0.0
    turb_intensity: float = 0.01        # DEFAULT_TURB_INTENSITY
    eddy_visc_ratio: float = 0.01       # DEFAULT_EDDY_VISC_RATIO
    mass_fractions: tuple = (1.0,)      # aligned with species order
    stagnation_pressure: float = 0.0
    stagnation_temperature: float = 0.0
    direction: tuple = (0.0, 0.0, 0.0)
    temperature: float = -1.0
    heat_flux: float = 0.0
    is_isothermal: bool = False
    is_constant_heat_flux: bool = False
    wall_law: bool = False
    von_karmen: float = 0.41
    wall_constant: float = 5.5
    nonreflecting: bool = False
    length_scale: float = 0.0


def make_bc_data(state_obj, deck) -> BCData:
    """Nondimensionalize a boundaryState object
    (reference: inputStates.cpp:464-505, 590-600, 674-685, 775-790)."""
    p = state_obj.params
    a, r, t, l = deck.a_ref, deck.r_ref, deck.t_ref, deck.l_ref
    mf = [0.0] * deck.num_species
    mfm = p.get("massFractions")
    if mfm:
        for name, frac in mfm.items():
            mf[deck.species_index(name)] = frac
    else:
        if "air" in deck.species_names:
            mf[deck.species_index("air")] = 1.0
        else:
            mf[0] = 1.0
    vel = p.get("velocity", [0.0, 0.0, 0.0])
    wall_treatment = p.get("wallTreatment", "lowRe")
    return BCData(
        tag=p.get("tag", -1),
        velocity=tuple(v / a for v in vel),
        density=p.get("density", 0.0) / r,
        pressure=p.get("pressure", 0.0) / (r * a * a),
        turb_intensity=p.get("turbulenceIntensity", 0.01),
        eddy_visc_ratio=p.get("eddyViscosityRatio", 0.01),
        mass_fractions=tuple(mf),
        stagnation_pressure=p.get("p0", 0.0) / (r * a * a),
        stagnation_temperature=p.get("t0", 0.0) / t,
        direction=tuple(_normalize(p.get("direction", [0.0, 0.0, 0.0]))),
        temperature=p.get("temperature", -1.0) / t,
        heat_flux=p.get("heatFlux", 0.0) / (a / l) ** 3,
        is_isothermal="temperature" in p,
        is_constant_heat_flux="heatFlux" in p,
        wall_law=wall_treatment == "wallLaw",
        von_karmen=p.get("vonKarmen", 0.41),
        wall_constant=p.get("wallConstant", 5.5),
        nonreflecting=p.get("nonreflecting", "false") in (True, "true"),
        length_scale=p.get("lengthScale", 0.0) / l,
    )


def _normalize(v):
    n = np.linalg.norm(v)
    return [x / n for x in v] if n > 0 else v


def _column(values, like):
    """a per-channel constant tuple as a (C, 1, ...) tensor broadcasting
    against the patch tensor ``like`` (C, ...)"""
    return torch.tensor(values, dtype=like.dtype, device=like.device
                        ).reshape((-1,) + (1,) * (like.dim() - 1))


def freestream_prim(phys: Physics, data: BCData, like):
    """Constant freestream primitive patch tensor from BC data."""
    shape = like.shape[1:]
    kw = dict(dtype=like.dtype, device=like.device)
    parts = [torch.full(shape, data.density * m, **kw)
             for m in data.mass_fractions]
    parts += [torch.full(shape, v, **kw) for v in data.velocity]
    parts += [torch.full(shape, data.pressure, **kw)]
    free = torch.stack(parts)
    if phys.nturb:
        free = torch.cat([free, torch.zeros((phys.nturb,) + shape, **kw)])
        vel = torch.tensor(data.velocity, **kw).reshape(
            (3,) + (1,) * len(shape)) * torch.ones((3,) + shape, **kw)
        free = apply_farfield_turb(phys, free, vel, data.turb_intensity,
                                   data.eddy_visc_ratio)
    return free


def apply_farfield_turb(phys: Physics, q, vel, ti, evr):
    """tke/omega farfield values (reference: primitive.cpp:66-80)."""
    vmag2 = (vel * vel).sum(dim=0)
    tke = 1.5 * ti * ti * vmag2
    r = st.rho(phys, q)
    mf = st.mixture_fractions(phys, q)
    t = st.temperature(phys, q)
    mu = phys.viscosity(t, mf)
    omega = r * tke / (evr * mu)
    tmin = phys.turb_min()
    q = q.clone()
    q[phys.it] = torch.clamp(tke, min=tmin[0])
    q[phys.it + 1] = torch.clamp(omega, min=tmin[1])
    return q


def extrapolate_hold_mixture(phys: Physics, boundary, factor, interior):
    """Linear extrapolation that preserves the boundary's mass-fraction mix
    and falls back to the boundary state when density would go nonpositive
    (reference: ghostStates.cpp:687-707)."""
    rho_b = st.rho(phys, boundary)
    rho_i = st.rho(phys, interior)
    rho_g = factor * rho_b - rho_i
    ok = rho_g > 0.0
    mf_b = boundary[:phys.ns] / rho_b[None]
    ghost = factor * boundary - interior
    ghost = torch.cat([torch.clamp(rho_g[None] * mf_b, min=0.0),
                       ghost[phys.ns:]])
    return torch.where(ok[None], ghost, boundary)


# ---------------------------------------------------------------------------
# per-BC ghost state functions.  `interior`: (neq, ...patch), `norm`:
# outward unit normal (3, ...patch).


def slip_wall(phys: Physics, interior, norm, data, layer):
    """Reflection (reference: ghostStates.cpp:109-129).  `interior` is the
    mirrored cell at the layer's depth."""
    vel = st.velocity(phys, interior)
    vn = (vel * norm).sum(dim=0)
    return torch.cat([interior[:phys.mx], vel - 2.0 * norm * vn[None],
                      interior[phys.ie:]])


def characteristic(phys: Physics, interior, norm, data: BCData, layer):
    """Riemann-invariant in/outflow (reference: ghostStates.cpp:287-388)."""
    free = freestream_prim(phys, data, interior)
    vel_i = st.velocity(phys, interior)
    vn = (vel_i * norm).sum(dim=0)
    sos_i = st.sos(phys, interior)
    mach = torch.abs(vn) / sos_i
    rho_i = st.rho(phys, interior)
    rho_sos = rho_i * sos_i
    p_i = st.pressure(phys, interior)
    p_f = st.pressure(phys, free)
    vel_f = st.velocity(phys, free)
    rho_f = st.rho(phys, free)
    mf_f = free[:phys.ns] / rho_f[None]
    mf_i = interior[:phys.ns] / rho_i[None]
    turb = [interior[phys.it:]] if phys.nturb else []

    # subsonic inflow
    vd = vel_f - vel_i
    p_si = 0.5 * (p_f + p_i - rho_sos * (norm * vd).sum(dim=0))
    dp_si = p_f - p_si
    rho_si = rho_f - dp_si / (sos_i * sos_i)
    vel_si = vel_f - norm * (dp_si / rho_sos)[None]
    ghost_si = torch.cat([rho_si[None] * mf_f, vel_si, p_si[None]] + turb)

    # subsonic outflow
    dp_so = p_i - p_f
    rho_so = rho_i - dp_so / (sos_i * sos_i)
    vel_so = vel_i + norm * (dp_so / rho_sos)[None]
    ghost_so = torch.cat([rho_so[None] * mf_i, vel_so, p_f[None]] + turb)

    sup_in = (mach >= 1.0) & (vn < 0.0)
    sub_in = (mach < 1.0) & (vn < 0.0)
    sub_out = (mach < 1.0) & (vn >= 0.0)

    ghost = torch.where(sup_in[None], free,
                        torch.where(sub_in[None], ghost_si,
                                    torch.where(sub_out[None], ghost_so,
                                                interior)))
    if phys.nturb:
        farfield = apply_farfield_turb(phys, ghost, vel_f,
                                       data.turb_intensity,
                                       data.eddy_visc_ratio)
        inflow = vn < 0.0
        ghost = torch.where(inflow[None], farfield, ghost)

    ghost = extrapolate_hold_mixture(phys, ghost, 2.0, interior)
    if layer > 1:
        ghost = extrapolate_hold_mixture(phys, ghost, float(layer), interior)
        if phys.nturb:
            ghost = apply_farfield_turb(phys, ghost, vel_f,
                                        data.turb_intensity,
                                        data.eddy_visc_ratio)
    return ghost


def inlet(phys: Physics, interior, norm, data: BCData, layer,
          state_n=None, dt=None, max_mach=None, avg_mach=None,
          pgrad=None, vgrad=None):
    """(reference: ghostStates.cpp:392-488), reflecting and nonreflecting
    (LODI) variants; a face with |vn| / a >= 1 takes the freestream."""
    free = freestream_prim(phys, data, interior)
    vel_i = st.velocity(phys, interior)
    vn = (vel_i * norm).sum(dim=0)
    sos_i = st.sos(phys, interior)
    mach = torch.abs(vn) / sos_i
    rho_sos = st.rho(phys, interior) * sos_i
    p_i = st.pressure(phys, interior)
    p_f = st.pressure(phys, free)
    vel_f = st.velocity(phys, free)
    rho_f = st.rho(phys, free)
    mf_f = free[:phys.ns] / rho_f[None]

    vd = vel_f - vel_i
    p_g = 0.5 * (p_f + p_i - rho_sos * (norm * vd).sum(dim=0))
    if data.nonreflecting and state_n is not None:
        # LODI minus characteristic (reference: ghostStates.cpp:437-460)
        sigma = 0.25
        rho_n = st.rho(phys, state_n)
        sos_n = st.sos(phys, state_n)
        rho_sos_n = rho_n * sos_n
        dp_n = p_g - st.pressure(phys, state_n)
        alpha = sigma * sos_n / data.length_scale
        rho_g = ((rho_n + dt * alpha * rho_f + dp_n / (sos_n * sos_n))
                 / (1.0 + dt * alpha))
        k = alpha * (1.0 - max_mach * max_mach)
        vel_g = (st.velocity(phys, state_n) + dt[None] * k[None] * vel_f
                 - norm * (dp_n / rho_sos_n)[None]) / (1.0 + dt * k)[None]
    else:
        dp = p_f - p_g
        rho_g = rho_f - dp / (sos_i * sos_i)
        vel_g = vel_f - norm * (dp / rho_sos)[None]
    sub = torch.cat([rho_g[None] * mf_f, vel_g, p_g[None]]
                    + ([interior[phys.it:]] if phys.nturb else []))
    if phys.nturb:
        sub = apply_farfield_turb(phys, sub, vel_f, data.turb_intensity,
                                  data.eddy_visc_ratio)
    sub = extrapolate_hold_mixture(phys, sub, 2.0, interior)
    if layer > 1:
        sub = extrapolate_hold_mixture(phys, sub, float(layer), interior)

    sup = free
    if phys.nturb:
        sup = apply_farfield_turb(phys, sup, vel_f, data.turb_intensity,
                                  data.eddy_visc_ratio)
    return torch.where((mach >= 1.0)[None], sup, sub)


def supersonic_inflow(phys: Physics, interior, norm, data: BCData, layer):
    """Fix the entire state (reference: ghostStates.cpp:494-523)."""
    return freestream_prim(phys, data, interior)


def supersonic_outflow(phys: Physics, interior, norm, data, layer):
    """Zeroth-order extrapolation (reference: ghostStates.cpp:525-533).
    Layers past the first take layer * interior - interior, as the JAX
    package does (``ghost`` is still the interior there)."""
    ghost = interior
    if layer > 1:
        ghost = float(layer) * ghost - interior
    return ghost


def stagnation_inlet(phys: Physics, interior, norm, data: BCData, layer):
    """Blazek stagnation inlet (reference: ghostStates.cpp:535-598)."""
    t_i = st.temperature(phys, interior)
    rho_i = st.rho(phys, interior)
    mf_i = interior[:phys.ns] / rho_i[None]
    g = phys.gamma(t_i, mf_i) - 1.0
    vel = st.velocity(phys, interior)
    sos_i = st.sos(phys, interior)
    vn = (vel * norm).sum(dim=0)
    r_neg = vn - 2.0 * sos_i / g
    vmag = torch.sqrt((vel * vel).sum(dim=0))
    cos_theta = -vn / torch.clamp(vmag, min=1.0e-30)
    stag_sos_sq = sos_i * sos_i + 0.5 * g * vmag * vmag
    sos_b = -r_neg * g / (g * cos_theta ** 2 + 2.0) * (
        1.0 + cos_theta * torch.sqrt(
            (g * cos_theta ** 2 + 2.0) * stag_sos_sq / (g * r_neg * r_neg)
            - 0.5 * g))
    tb = data.stagnation_temperature * (sos_b * sos_b / stag_sos_sq)
    pb = data.stagnation_pressure * (sos_b * sos_b / stag_sos_sq) ** (
        (g + 1.0) / g)
    vb_mag = torch.sqrt(2.0 / g * (data.stagnation_temperature - tb))

    mf = _column(data.mass_fractions, interior) * torch.ones_like(
        interior[:phys.ns])
    rho_g = phys.density_tp(tb, pb, mf)
    d = _column(data.direction, interior)
    ghost = torch.cat([rho_g[None] * mf, vb_mag[None] * d
                       * torch.ones_like(vel), pb[None]]
                      + ([interior[phys.it:]] if phys.nturb else []))
    if phys.nturb:
        ghost = apply_farfield_turb(phys, ghost, st.velocity(phys, ghost),
                                    data.turb_intensity, data.eddy_visc_ratio)
    ghost = extrapolate_hold_mixture(phys, ghost, 2.0, interior)
    if layer > 1:
        ghost = extrapolate_hold_mixture(phys, ghost, float(layer), interior)
        if phys.nturb:
            ghost = apply_farfield_turb(phys, ghost,
                                        st.velocity(phys, ghost),
                                        data.turb_intensity,
                                        data.eddy_visc_ratio)
    return ghost


def pressure_outlet(phys: Physics, interior, norm, data: BCData, layer,
                    state_n=None, dt=None, max_mach=None, avg_mach=None,
                    pgrad=None, vgrad=None):
    """Blazek pressure outlet (reference: ghostStates.cpp:600-670) with the
    nonreflecting (LODI with transverse terms) variant; a face whose ghost
    is supersonic extrapolates the interior."""
    pb = data.pressure
    sos_i = st.sos(phys, interior)
    rho_i = st.rho(phys, interior)
    rho_sos = rho_i * sos_i
    p_i = st.pressure(phys, interior)
    vel_i = st.velocity(phys, interior)
    mf_i = interior[:phys.ns] / rho_i[None]

    if data.nonreflecting and state_n is not None:
        # LODI terms (reference: ghostStates.cpp:610-645).  vgrad
        # convention, as the viscous residual's cell averages:
        # vgrad[a, b] = d v_b / d x_a.
        sigma = 0.25
        vel_n = st.velocity(phys, state_n)
        rho_n = st.rho(phys, state_n)
        sos_n = st.sos(phys, state_n)
        rho_sos_n = rho_n * sos_n
        p_n = st.pressure(phys, state_n)
        delta_vel = ((vel_i - vel_n) * norm).sum(dim=0)
        k = sigma * sos_n * (1.0 - max_mach * max_mach) / data.length_scale
        beta = avg_mach
        pgrad_t = pgrad - (pgrad * norm).sum(dim=0)[None] * norm
        vel_t = vel_n - (vel_n * norm).sum(dim=0)[None] * norm
        # remove the normal component of each velocity component's gradient
        vgrad_t = vgrad - torch.einsum("ab...,a...->b...", vgrad, norm
                                       )[None, :] * norm[:, None]
        dveln_dtrans = torch.einsum("ab...,b...->a...", vgrad_t, norm)
        dvelt_dtrans = vgrad_t.sum(dim=(0, 1)) - dveln_dtrans.sum(dim=0)
        mf_n = state_n[:phys.ns] / rho_n[None]
        t_n = st.temperature(phys, state_n)
        gam = phys.gamma(t_n, mf_n)
        trans = -0.5 * ((vel_t * (pgrad_t
                                  - rho_sos_n[None] * dveln_dtrans)
                         ).sum(dim=0) + gam * p_n * dvelt_dtrans)
        p_ghost = (p_n + rho_sos_n * delta_vel + dt * k * pb
                   - dt * beta * trans) / (1.0 + dt * k)
    else:
        p_ghost = torch.full_like(p_i, pb)

    dp = p_i - p_ghost
    rho_g = rho_i - dp / (sos_i * sos_i)
    vel_g = vel_i + norm * (dp / rho_sos)[None]
    ghost = torch.cat([rho_g[None] * mf_i, vel_g, p_ghost[None]]
                      + ([interior[phys.it:]] if phys.nturb else []))
    # supersonic: pure extrapolation
    sup = ((st.velocity(phys, ghost) * norm).sum(dim=0)
           / st.sos(phys, ghost)) >= 1.0
    ghost = torch.where(sup[None], interior, ghost)
    ghost = 2.0 * ghost - interior
    if layer > 1:
        ghost = float(layer) * ghost - interior
    return ghost


def viscous_wall(phys: Physics, interior, norm, data: BCData, layer,
                 wall_dist=None, nu_w=None, cfg=None, wvars_out=None):
    """Viscous wall, low-Re or wall-law treatment (reference:
    ghostStates.cpp:130-285): no-slip velocity reflection, isothermal /
    constant-heat-flux / adiabatic density ghosts, and the omega wall
    value with the model's beta.  For the wall law the White-Christoph
    solve (``wall_law.solve_wall_law``) runs on the mirror-cell states of
    the layer, as in the JAX package, and the temperature and turbulence
    ghosts take the wall values unless the y+ < 10 low-Re switch triggers
    per face (wallData.hpp:57); its values go into ``wvars_out``."""
    vel_wall = _column(data.velocity, interior)
    vel_i = interior[phys.mx:phys.mx + 3]
    vel_g = 2.0 * vel_wall - vel_i
    rho_s = interior[:phys.ns]
    p = interior[phys.ie]

    rho_i = st.rho(phys, interior)
    mf = interior[:phys.ns] / rho_i[None]
    t_i = st.temperature(phys, interior)

    wv = None
    if data.wall_law:
        wv = wall_law.solve_wall_law(
            phys, cfg, interior, norm, wall_dist,
            von_karmen=data.von_karmen, wall_const=data.wall_constant,
            t_wall=data.temperature if data.is_isothermal else None,
            heat_flux=data.heat_flux if data.is_constant_heat_flux else None,
            vel_wall=data.velocity)
        if wvars_out is not None:
            wvars_out.update(wv)
        low_re = wv["low_re"]

    if data.is_isothermal:
        t_ghost = 2.0 * data.temperature - t_i
        if data.wall_law:
            # wall-law heat flux sets the ghost temperature; the eddy
            # viscosity is nonzero at the wall (ghostStates.cpp:160-175)
            kappa = (phys.effective_conductivity(wv["t"], mf)
                     + wv["mut"] * phys.mix(phys.species_cp(wv["t"]), mf)
                     / phys.turb_prandtl())
            t_wl = data.temperature - wv["q"] / kappa * 2.0 * wall_dist
            t_ghost = torch.where(low_re, t_ghost, t_wl)
        rho_s = phys.density_tp(t_ghost, p, mf)[None] * mf
    elif data.is_constant_heat_flux:
        kappa = phys.effective_conductivity(t_i, mf)
        t_ghost = t_i - data.heat_flux / kappa * 2.0 * wall_dist
        if data.wall_law:
            t_ghost = torch.where(low_re, t_ghost, 2.0 * wv["t"] - t_i)
        rho_s = phys.density_tp(t_ghost, p, mf)[None] * mf
    # adiabatic: numerical BCs for density/pressure

    parts = [rho_s, vel_g, p[None]]
    if phys.nturb:
        scaling = phys.nondim_scaling
        tke_g = -interior[phys.it]
        w_wall = scaling * scaling * 60.0 * nu_w / (
            wall_dist * wall_dist * wall_beta(phys.turb_model))
        omega_g = 2.0 * w_wall - interior[phys.it + 1]
        if layer > 1:
            omega_g = layer * omega_g - w_wall
        if data.wall_law:
            tke_wl = 2.0 * wv["tke"] - interior[phys.it]
            sdr_wl = 2.0 * wv["sdr"] - interior[phys.it + 1]
            if layer > 1:
                tke_wl = layer * tke_wl - wv["tke"]
                sdr_wl = layer * sdr_wl - wv["sdr"]
            tke_g = torch.where(low_re, tke_g, tke_wl)
            omega_g = torch.where(low_re, omega_g, sdr_wl)
        parts += [tke_g[None], omega_g[None]]
    return torch.cat(parts)


GHOST_FUNCS = {
    "slipWall": slip_wall,
    "viscousWall": viscous_wall,
    "characteristic": characteristic,
    "inlet": inlet,
    "supersonicInflow": supersonic_inflow,
    "supersonicOutflow": supersonic_outflow,
    "stagnationInlet": stagnation_inlet,
    "pressureOutlet": pressure_outlet,
}


def ghost_state(phys: Physics, bc_type: str, interior, norm, data, layer,
                **kw):
    if bc_type not in GHOST_FUNCS:
        raise ValueError(f"unsupported BC type {bc_type!r}")
    return GHOST_FUNCS[bc_type](phys, interior, norm, data, layer, **kw)
