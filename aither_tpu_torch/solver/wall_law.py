"""White-Christoph law of the wall over wall-face slabs.

Port of ``aither_tpu/solver/wall_law.py`` (reference: src/wallLaw.cpp:
31-290, include/wallLaw.hpp:34-121): given the wall-adjacent interior
state, wall distance and outward unit normal, solve for y+ with Ridder's
method (reference: include/utility.hpp:130-184, bracket [10, 1e4], tol
1e-8) on

    y+ = u+ + y+White - y0+ (1 + ku + (ku)^2/2 + (ku)^3/6)

and derive the wall shear stress, heat flux, eddy viscosity and the k /
omega wall values the ghost states take (Nichols & Nelson 2004).

Every face of a slab solves at once: a fixed RIDDER_ITERS-iteration loop
of elementwise tensor code whose ``done`` mask freezes a converged face,
as the JAX package's ``fori_loop``.  The loop reads nothing back to the
host (no early exit), so it queues on the device without a sync.
"""

from __future__ import annotations

import math

import torch

from ..physics.models import Physics
from . import state as st
from .viscous import SST, WILCOX, wall_beta

YPLUS_LO = 1.0e1
YPLUS_HI = 1.0e4
RIDDER_TOL = 1.0e-8
RIDDER_ITERS = 60


def _wall_props(phys: Physics, t_wall, p_int, mf):
    """rhoW, muW, kW at the wall temperature (reference:
    wallLaw.cpp:239-246; EffectiveViscosity includes NondimScaling,
    transport.cpp:166-170)."""
    scaling = phys.nondim_scaling
    rho_w = phys.density_tp(t_wall, p_int, mf)
    mu_w = scaling * phys.viscosity(t_wall, mf)
    k_w = scaling * phys.conductivity(t_wall, mf)
    return rho_w, mu_w, k_w


def solve_wall_law(phys: Physics, cfg, interior, norm, wall_dist,
                   von_karmen=0.41, wall_const=5.5, t_wall=None,
                   heat_flux=None, vel_wall=(0.0, 0.0, 0.0)):
    """Solve the wall law on a slab of wall-adjacent interior states.

    interior: (neq, ...) wall-adjacent primitive states
    norm: (3, ...) outward unit normals; wall_dist: (...) distances.
    t_wall / heat_flux: isothermal or constant-heat-flux variants
    (reference: wallLaw.cpp:89-200); both None = adiabatic.

    Returns a dict of face slabs: t, rho, mu, mut, u_star, yplus, tau
    (3, ...), q (heat flux), tke, sdr, low_re (the y+ < 10 switch mask).
    """
    ns = phys.ns
    mf = interior[:ns] / st.rho(phys, interior)[None]
    vw = torch.tensor(vel_wall, dtype=interior.dtype,
                      device=interior.device).reshape(
        (3,) + (1,) * (interior.dim() - 1))
    vel = st.velocity(phys, interior) - vw
    vel_tan = vel - (vel * norm).sum(dim=0)[None] * norm
    u_tan = torch.sqrt((vel_tan * vel_tan).sum(dim=0))
    u_tan = torch.clamp(u_tan, min=1.0e-30)
    t_int = st.temperature(phys, interior)
    p_int = st.pressure(phys, interior)
    cp = phys.mix(phys.species_cp(t_int), mf)
    # recovery factor = Pr^(1/3) with Pr = 4g/(9g-5) (reference:
    # wallLaw.cpp:287-290, thermodynamic.hpp:61-64)
    gam = phys.gamma(t_int, mf)
    pr = 4.0 * gam / (9.0 * gam - 5.0)
    rf = pr ** (1.0 / 3.0)
    yplus0 = math.exp(-von_karmen * wall_const)
    scaling = phys.nondim_scaling

    adiabatic = t_wall is None and heat_flux is None
    isothermal = t_wall is not None

    if adiabatic:
        tw = t_int + 0.5 * rf * u_tan * u_tan / cp
    elif isothermal:
        tw = torch.full_like(u_tan, t_wall)
    else:
        tw = t_int  # initial guess, updated in the residual function

    def fres(yplus, tw_c):
        """Wall-law residual at y+ (reference: wallLaw.cpp:54-65,110-124,
        166-179).  Returns (residual, state dict)."""
        rho_w, mu_w, k_w = _wall_props(phys, tw_c, p_int, mf)
        uplus = wall_dist * rho_w * u_tan / (mu_w * yplus)
        u_star = u_tan / uplus
        tw_new = tw_c
        if adiabatic or isothermal:
            q_w = torch.zeros_like(u_tan)
            gamma = rf * u_star * u_star / (2.0 * cp * tw_c)
            if isothermal:
                q_w = ((t_int / tw_c - 1.0 + gamma * uplus * uplus) / uplus
                       ) * (rho_w * tw_c * k_w * u_star) / mu_w
        else:
            q_w = torch.full_like(u_tan, heat_flux)
            tw_new = t_int + rf * u_star * u_star * uplus * uplus / (
                2.0 * cp + q_w * mu_w / (rho_w * k_w * u_star))
            rho_w, mu_w, k_w = _wall_props(phys, tw_new, p_int, mf)
            gamma = rf * u_star * u_star / (2.0 * cp * tw_new)
        beta = q_w * mu_w / (rho_w * tw_new * k_w * u_star)
        q = torch.sqrt(beta * beta + 4.0 * gamma)
        phi = torch.arcsin(-beta / q)
        yp_white = torch.exp((von_karmen / torch.sqrt(gamma)) * (
            torch.arcsin(torch.clamp((2.0 * gamma * uplus - beta) / q,
                                     -1.0, 1.0)) - phi)) * yplus0
        ku = von_karmen * uplus
        res = yplus - (uplus + yp_white
                       - yplus0 * (1.0 + ku + 0.5 * ku * ku
                                   + ku * ku * ku / 6.0))
        stv = dict(uplus=uplus, u_star=u_star, rho=rho_w, mu=mu_w, k=k_w,
                   tw=tw_new, q_w=q_w, gamma=gamma, beta=beta, qq=q,
                   yp_white=yp_white)
        return res, stv

    # vectorized Ridder on the bracket [10, 1e4]
    x1 = torch.full_like(u_tan, YPLUS_LO)
    x2 = torch.full_like(u_tan, YPLUS_HI)
    f1, _ = fres(x1, tw)
    f2, stv = fres(x2, tw)
    if not (adiabatic or isothermal):
        tw = stv["tw"]
    bracketed = torch.sign(f1) != torch.sign(f2)

    x4 = torch.full_like(u_tan, YPLUS_HI)
    done = ~bracketed
    for _ in range(RIDDER_ITERS):
        x3 = 0.5 * (x1 + x2)
        f3, stv3 = fres(x3, tw)
        if not (adiabatic or isothermal):
            tw = torch.where(done, tw, stv3["tw"])
        denom = torch.sqrt(torch.abs(f3 * f3 - f1 * f2)) + 1.0e-300
        fac = torch.sign(f1 - f2)
        x4n = x3 + (x3 - x1) * (fac * f3) / denom
        f4, _ = fres(x4n, tw)
        x4 = torch.where(done, x4, x4n)
        # bracket update (reference: utility.hpp:164-175)
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
        done = done | (torch.abs(x2 - x1) <= RIDDER_TOL)

    yplus = torch.where(bracketed, x4, YPLUS_HI)
    _, s = fres(yplus, tw)

    # eddy viscosity from the wall law (reference: wallLaw.cpp:255-266)
    uplus, u_star = s["uplus"], s["u_star"]
    mu_w, rho_w, tw = s["mu"], s["rho"], s["tw"]
    gamma, beta, qq, yp_white = s["gamma"], s["beta"], s["qq"], s["yp_white"]
    dyp_white = (2.0 * yp_white * von_karmen * torch.sqrt(gamma) / qq
                 * torch.sqrt(torch.clamp(
                     1.0 - (2.0 * gamma * uplus - beta) ** 2 / (qq * qq),
                     min=0.0)))
    ku = von_karmen * uplus
    mu_int = scaling * phys.viscosity(t_int, mf)
    mut_w = mu_w * (1.0 + dyp_white
                    - von_karmen * yplus0 * (1.0 + ku + 0.5 * ku * ku)) \
        - mu_int
    mut_w = torch.clamp(mut_w, min=0.0)

    # k / omega wall values (reference: wallLaw.cpp:274-285)
    model = cfg["turb_model"]
    beta_star = WILCOX["beta_star"] if model == "kOmegaWilcox2006" \
        else SST["beta_star"]
    wi = scaling * 6.0 * mu_w / (wall_beta(model) * rho_w
                                 * wall_dist * wall_dist)
    wo = scaling * u_star / (math.sqrt(beta_star) * von_karmen * wall_dist)
    sdr_w = torch.sqrt(wi * wi + wo * wo)
    tke_w = sdr_w * mut_w / st.rho(phys, interior) / scaling

    tau_mag = u_star * u_star * rho_w
    tau = tau_mag[None] * vel_tan / u_tan[None]

    return dict(t=tw, rho=rho_w, mu=mu_w, mut=mut_w, u_star=u_star,
                yplus=yplus, tau=tau, q=s["q_w"], tke=tke_w, sdr=sdr_w,
                low_re=yplus < 10.0)
