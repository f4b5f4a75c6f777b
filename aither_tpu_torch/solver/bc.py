"""Boundary-condition ghost states over boundary patches.

Port of ``aither_tpu/solver/bc.py`` for the slice's boundary types:
slipWall, characteristic and the low-Re viscousWall (isothermal, constant
heat flux or adiabatic), plus the ``ghost_state`` dispatch (reference:
src/ghostStates.cpp:60-388), for any species count: boundary states carry
their mass fractions, the viscous wall keeps the interior's.  Each function maps (interior patch state,
outward unit normal, static BC data) -> ghost patch state.
"""

from __future__ import annotations

import dataclasses

import torch

from ..physics.models import Physics
from ..unsupported import refuse
from . import state as st
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
    temperature: float = -1.0
    heat_flux: float = 0.0
    is_isothermal: bool = False
    is_constant_heat_flux: bool = False


def make_bc_data(state_obj, deck) -> BCData:
    """Nondimensionalize a boundaryState object
    (reference: inputStates.cpp:464-505, 590-600, 674-685, 775-790)."""
    p = state_obj.params
    if p.get("wallTreatment", "lowRe") == "wallLaw":
        refuse("wallLaw")
    if p.get("nonreflecting", "false") in (True, "true"):
        refuse("nonreflecting")
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
    return BCData(
        tag=p.get("tag", -1),
        velocity=tuple(v / a for v in vel),
        density=p.get("density", 0.0) / r,
        pressure=p.get("pressure", 0.0) / (r * a * a),
        turb_intensity=p.get("turbulenceIntensity", 0.01),
        eddy_visc_ratio=p.get("eddyViscosityRatio", 0.01),
        mass_fractions=tuple(mf),
        temperature=p.get("temperature", -1.0) / t,
        heat_flux=p.get("heatFlux", 0.0) / (a / l) ** 3,
        is_isothermal="temperature" in p,
        is_constant_heat_flux="heatFlux" in p,
    )


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


def viscous_wall(phys: Physics, interior, norm, data: BCData, layer,
                 wall_dist=None, nu_w=None):
    """Low-Re viscous wall (reference: ghostStates.cpp:130-285): no-slip
    velocity reflection, isothermal / constant-heat-flux / adiabatic
    density ghosts, and the omega wall value with the model's beta."""
    kw = dict(dtype=interior.dtype, device=interior.device)
    vel_wall = torch.tensor(data.velocity, **kw).reshape(
        (3,) + (1,) * (interior.dim() - 1))
    vel_i = interior[phys.mx:phys.mx + 3]
    vel_g = 2.0 * vel_wall - vel_i
    rho_s = interior[:phys.ns]
    p = interior[phys.ie]

    rho_i = st.rho(phys, interior)
    mf = interior[:phys.ns] / rho_i[None]
    t_i = st.temperature(phys, interior)

    if data.is_isothermal:
        t_ghost = 2.0 * data.temperature - t_i
        rho_g = phys.density_tp(t_ghost, p, mf)
        rho_s = rho_g[None] * mf
    elif data.is_constant_heat_flux:
        kappa = phys.effective_conductivity(t_i, mf)
        t_ghost = t_i - data.heat_flux / kappa * 2.0 * wall_dist
        rho_g = phys.density_tp(t_ghost, p, mf)
        rho_s = rho_g[None] * mf
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
        parts += [tke_g[None], omega_g[None]]
    return torch.cat(parts)


GHOST_FUNCS = {
    "slipWall": slip_wall,
    "viscousWall": viscous_wall,
    "characteristic": characteristic,
}


def ghost_state(phys: Physics, bc_type: str, interior, norm, data, layer,
                **kw):
    if bc_type not in GHOST_FUNCS:
        refuse("boundaryCondition", bc_type)
    return GHOST_FUNCS[bc_type](phys, interior, norm, data, layer, **kw)

