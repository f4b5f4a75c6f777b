"""Inviscid flux functions over faces.

Port of ``aither_tpu/solver/flux.py`` (reference:
include/inviscidFlux.hpp:128-538): Roe with Harten's entropy fix,
AUSMPW+ and Rusanov.  Left/right primitive states are (neq, ...), the unit
face normal is (3, ...), and the flux per unit area is (neq, ...).
"""

from __future__ import annotations

import torch

from ..physics.models import Physics
from . import state as st

ENTROPY_FIX = 0.1  # Harten entropy fix threshold (inviscidFlux.hpp:298)


def physical_flux(phys: Physics, q, n):
    """F(q)·n per unit area (reference: inviscidFlux.hpp:128-159)."""
    vel = st.velocity(phys, q)
    vn = (vel * n).sum(dim=0)
    r = st.rho(phys, q)
    p = st.pressure(phys, q)
    h0 = st.enthalpy(phys, q)
    parts = [q[:phys.ns] * vn[None],
             (r * vn)[None] * vel + p[None] * n,
             (r * vn * h0)[None]]
    if phys.nturb:
        parts.append((r * vn)[None] * q[phys.it:])
    return torch.cat(parts, dim=0)


def _entropy_fix(ws):
    return torch.where(ws < ENTROPY_FIX,
                       0.5 * (ws * ws / ENTROPY_FIX + ENTROPY_FIX), ws)


def roe_flux(phys: Physics, ql, qr, n):
    """Roe flux-difference splitting with Harten entropy fix
    (reference: inviscidFlux.hpp:259-382, after Blazek 4.3.3).

    The dissipation is accumulated row block by row block in the same
    order as the JAX package's ``diss.at[...].add`` chain."""
    ns, mx, ie, it = phys.ns, phys.mx, phys.ie, phys.it
    roe = st.roe_average(phys, ql, qr)
    rho_r = st.rho(phys, roe)
    mf_r = roe[:ns] / rho_r[None]
    h_r = st.enthalpy(phys, roe)
    a_r = st.sos(phys, roe)
    vel_r = st.velocity(phys, roe)
    vn_r = (vel_r * n).sum(dim=0)

    delta = qr - ql
    dvel = delta[mx:mx + 3]
    dvn = (dvel * n).sum(dim=0)
    dp = delta[ie]
    drho = delta[:ns].sum(dim=0)

    a2 = a_r * a_r
    # diss starts at zero; 0 + x is exact, so the first add is a plain copy
    # left moving acoustic wave
    ws = _entropy_fix(torch.abs(vn_r - a_r))
    strength = (dp - rho_r * a_r * dvn) / (2.0 * a2)
    wss = ws * strength
    d_s = wss[None] * mf_r
    d_m = wss[None] * (vel_r - a_r[None] * n)
    d_e = wss * (h_r - a_r * vn_r)
    d_t = wss[None] * roe[it:] if phys.nturb else None

    # entropy wave (species) + shear wave
    ws = torch.abs(vn_r)
    strength_s = -dp / a2
    d_s = d_s + ((ws * strength_s)[None] * mf_r + ws[None] * delta[:ns])
    strength = drho - dp / a2
    wss = ws * strength
    d_m = d_m + wss[None] * vel_r
    d_e = d_e + wss * 0.5 * (vel_r * vel_r).sum(dim=0)
    # shear wave
    wss = ws * rho_r
    d_m = d_m + wss[None] * (dvel - dvn[None] * n)
    d_e = d_e + wss * ((vel_r * dvel).sum(dim=0) - vn_r * dvn)

    # right moving acoustic wave
    ws = _entropy_fix(torch.abs(vn_r + a_r))
    strength = (dp + rho_r * a_r * dvn) / (2.0 * a2)
    wss = ws * strength
    d_s = d_s + wss[None] * mf_r
    d_m = d_m + wss[None] * (vel_r + a_r[None] * n)
    d_e = d_e + wss * (h_r + a_r * vn_r)
    parts = [d_s, d_m, d_e[None]]
    if phys.nturb:
        d_t = d_t + wss[None] * roe[it:]
        # turbulence waves
        ws = torch.abs(vn_r)
        strength_t = (rho_r[None] * delta[it:]
                      + roe[it:] * drho[None]
                      - (dp / a2)[None] * roe[it:])
        d_t = d_t + ws[None] * strength_t
        parts.append(d_t)
    diss = torch.cat(parts, dim=0)

    fl = physical_flux(phys, ql, n)
    fr = physical_flux(phys, qr, n)
    return 0.5 * (fl + fr - diss)


def ausm_flux(phys: Physics, ql, qr, n):
    """AUSMPW+ flux (Kim, Kim & Rho 1998)
    (reference: inviscidFlux.hpp:384-481)."""
    vel_l = st.velocity(phys, ql)
    vel_r = st.velocity(phys, qr)
    vnl = (vel_l * n).sum(dim=0)
    vnr = (vel_r * n).sum(dim=0)
    sos_l = st.sos(phys, ql)
    sos_r = st.sos(phys, qr)
    sos_star = torch.sqrt(sos_l * sos_r)

    vbar = 0.5 * (vnl + vnr)
    sos = torch.where(
        vbar < 0.0, sos_star * sos_star / torch.maximum(vnr, sos_star),
        torch.where(vbar > 0.0,
                    sos_star * sos_star / torch.maximum(vnl, sos_star),
                    sos_star))

    ml = vnl / sos
    mr = vnr / sos

    m_plus = torch.where(torch.abs(ml) <= 1.0, 0.25 * (ml + 1.0) ** 2,
                         0.5 * (ml + torch.abs(ml)))
    m_minus = torch.where(torch.abs(mr) <= 1.0, -0.25 * (mr - 1.0) ** 2,
                          0.5 * (mr - torch.abs(mr)))
    p_plus = torch.where(torch.abs(ml) <= 1.0,
                         0.25 * (ml + 1.0) ** 2 * (2.0 - ml),
                         0.5 * (1.0 + torch.sign(ml)))
    p_minus = torch.where(torch.abs(mr) <= 1.0,
                          0.25 * (mr - 1.0) ** 2 * (2.0 + mr),
                          0.5 * (1.0 - torch.sign(mr)))

    pl = st.pressure(phys, ql)
    pr = st.pressure(phys, qr)
    ps = p_plus * pl + p_minus * pr
    w = 1.0 - torch.minimum(pl / pr, pr / pl) ** 3
    fl_ = torch.where(torch.abs(ml) < 1.0, pl / ps - 1.0, 0.0)
    fr_ = torch.where(torch.abs(mr) < 1.0, pr / ps - 1.0, 0.0)

    mavg = m_plus + m_minus
    m_plus_bar = torch.where(
        mavg >= 0.0, m_plus + m_minus * ((1.0 - w) * (1.0 + fr_) - fl_),
        m_plus * w * (1.0 + fl_))
    m_minus_bar = torch.where(
        mavg >= 0.0, m_minus * w * (1.0 + fr_),
        m_minus + m_plus * ((1.0 - w) * (1.0 + fl_) - fr_))

    def side(q, mbar, psplit, vel):
        v = mbar * sos
        r = st.rho(phys, q)
        p = st.pressure(phys, q)
        h0 = st.enthalpy(phys, q)
        parts = [q[:phys.ns] * v[None],
                 (r * v)[None] * vel + (psplit * p)[None] * n,
                 (r * v * h0)[None]]
        if phys.nturb:
            parts.append((r * v)[None] * q[phys.it:])
        return torch.cat(parts, dim=0)

    return (side(ql, m_plus_bar, p_plus, vel_l)
            + side(qr, m_minus_bar, p_minus, vel_r))


def rusanov_flux(phys: Physics, ql, qr, n, positive: bool):
    """Rusanov flux (reference: inviscidFlux.hpp:508-538)."""
    sr_l = torch.abs((st.velocity(phys, ql) * n).sum(0)) + st.sos(phys, ql)
    sr_r = torch.abs((st.velocity(phys, qr) * n).sum(0)) + st.sos(phys, qr)
    fac = -1.0 if positive else 1.0
    spec = fac * torch.maximum(sr_l, sr_r)
    fl = physical_flux(phys, ql, n)
    fr = physical_flux(phys, qr, n)
    return 0.5 * (fl + fr - spec[None])


def inviscid_flux(phys: Physics, ql, qr, n, scheme: str):
    if scheme == "roe":
        return roe_flux(phys, ql, qr, n)
    if scheme == "ausm":
        return ausm_flux(phys, ql, qr, n)
    raise ValueError(f"unknown inviscid flux scheme {scheme!r}")
