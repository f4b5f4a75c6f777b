"""Block flux Jacobians for the block-matrix LU-SGS solver (blusgs).

Port of ``aither_tpu/solver/block_jac.py``: per-cell flow (N x N,
N = ns + 4) and turbulence (2 x 2) blocks, batched over cells with the
matrix axes last, as plain PyTorch, for any species count: the mixture's
gamma, energy, conductivity and cp, and with more than one species and
``cfg['diffusion']`` schmidt the species-diffusion rows of the
thin-shear-layer Jacobian (``_tsl_rows``).

Math follows the reference (reference: include/fluxJacobian.hpp:440-760:
RusanovFluxJacobian / InvFluxJacobian / ApproxTSLJacobian /
DelprimitiveDelConservative after Dwight; turbulence 2x2 blocks from
turbulence.cpp:84-140, 323-360, 500-540).  ``rows_matvec`` and the
``*_matvec`` functions are the channel-first forms the sweep kernel
(``csrc/blusgs_sweep.cu``) evaluates row by row.
"""

from __future__ import annotations

import torch

from ..physics.models import Physics
from . import state as st
from .viscous import SST, WILCOX, sigma_k, sigma_w, tau_normal


def _assemble(rows):
    """rows: list (len N) of lists (len N) of (...)-shaped entries ->
    (..., N, N)"""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rows_matvec(rows, x, scale=None):
    """Apply an N x N Jacobian held as a list of lists of (...)-shaped
    entries to x: (N, ...) -> (N, ...), one row at a time."""
    out = []
    for r in rows:
        acc = 0.0
        for j, e in enumerate(r):
            acc = acc + e * x[j]
        out.append(acc if scale is None else acc * scale)
    return torch.stack(out)


def _inv_flux_rows(phys: Physics, q, n, mag):
    """Rows of 0.5*|A| * dF/dU, the 0.5*mag factor folded into the
    entries (reference: fluxJacobian.hpp:484-580)."""
    ns = phys.ns
    N = ns + 4
    t = st.temperature(phys, q)
    mf = q[:ns] / st.rho(phys, q)[None]
    gamma = phys.gamma(t, mf)
    vel = st.velocity(phys, q)
    vn = (vel * n).sum(dim=0)
    gm1 = gamma - 1.0
    vmag2 = (vel * vel).sum(dim=0)
    phi = 0.5 * gm1 * vmag2
    energy = phys.mix(phys.species_energy(t), mf) + 0.5 * vmag2
    a1 = gamma * energy - phi
    a3 = gamma - 2.0
    u, v, w = vel
    nx, ny, nz = n
    zero = torch.zeros_like(vn)

    rows = [[zero] * N for _ in range(N)]
    for i in range(ns):
        for j in range(ns):
            kron = 1.0 if i == j else 0.0
            rows[i][j] = vn * (kron - mf[i])
        rows[i][ns + 0] = mf[i] * nx
        rows[i][ns + 1] = mf[i] * ny
        rows[i][ns + 2] = mf[i] * nz
        rows[ns + 0][i] = phi * nx - u * vn
        rows[ns + 1][i] = phi * ny - v * vn
        rows[ns + 2][i] = phi * nz - w * vn
        rows[ns + 3][i] = vn * (phi - a1)

    rows[ns + 0][ns + 0] = vn - a3 * nx * u
    rows[ns + 1][ns + 0] = v * nx - gm1 * u * ny
    rows[ns + 2][ns + 0] = w * nx - gm1 * u * nz
    rows[ns + 3][ns + 0] = a1 * nx - gm1 * u * vn

    rows[ns + 0][ns + 1] = u * ny - gm1 * v * nx
    rows[ns + 1][ns + 1] = vn - a3 * ny * v
    rows[ns + 2][ns + 1] = w * ny - gm1 * v * nz
    rows[ns + 3][ns + 1] = a1 * ny - gm1 * v * vn

    rows[ns + 0][ns + 2] = u * nz - gm1 * w * nx
    rows[ns + 1][ns + 2] = v * nz - gm1 * w * ny
    rows[ns + 2][ns + 2] = vn - a3 * nz * w
    rows[ns + 3][ns + 2] = a1 * nz - gm1 * w * vn

    rows[ns + 0][ns + 3] = gm1 * nx * torch.ones_like(vn)
    rows[ns + 1][ns + 3] = gm1 * ny * torch.ones_like(vn)
    rows[ns + 2][ns + 3] = gm1 * nz * torch.ones_like(vn)
    rows[ns + 3][ns + 3] = gamma * vn

    half_mag = 0.5 * mag
    return [[e * half_mag for e in r] for r in rows]


def inv_flux_jacobian(phys: Physics, q, n, mag):
    """0.5*|A| * dF/dU at the given state.  q: (neq, ...), n: (3, ...),
    mag: (...).  Returns (..., N, N)."""
    return _assemble(_inv_flux_rows(phys, q, n, mag))


def _rusanov_diagonals(phys: Physics, q, n, mag, positive: bool):
    """(flow spectral radius 0.5|A|(|vn| + a), turbulence diagonal
    0.5|A|(vn +- |vn|))"""
    vn = (st.velocity(phys, q) * n).sum(dim=0)
    spec = 0.5 * mag * (torch.abs(vn) + st.sos(phys, q))
    conv = 0.5 * vn * mag
    dissp = 0.5 * torch.abs(vn) * mag
    return spec, (conv + dissp if positive else conv - dissp)


def rusanov_flux_jacobian(phys: Physics, q, n, mag, positive: bool):
    """0.5|A|(dF/dU +- specRad*I) flow block and 0.5|A|(vn +- |vn|)*I turb
    block (reference: fluxJacobian.hpp:448-481)."""
    jac = inv_flux_jacobian(phys, q, n, mag)
    spec, tdiag = _rusanov_diagonals(phys, q, n, mag, positive)
    eye = torch.eye(phys.ns + 4, dtype=q.dtype, device=q.device)
    diss = spec[..., None, None] * eye
    flow = jac + diss if positive else jac - diss
    turb = None
    if phys.nturb:
        turb = tdiag[..., None, None] * torch.eye(2, dtype=q.dtype,
                                                  device=q.device)
    return flow, turb


def rusanov_offdiag_matvec(phys: Physics, q, n, mag, positive: bool, du):
    """Channel-first rusanov_flux_jacobian applied to du (neq, ...)."""
    N = phys.ns + 4
    yf = rows_matvec(_inv_flux_rows(phys, q, n, mag), du[:N])
    spec, tdiag = _rusanov_diagonals(phys, q, n, mag, positive)
    yf = yf + spec[None] * du[:N] if positive else yf - spec[None] * du[:N]
    if not phys.nturb:
        return yf
    return torch.cat([yf, tdiag[None] * du[phys.it:]], dim=0)


def _del_prim_del_cons_rows(phys: Physics, q):
    """Rows of d(primitive)/d(conservative)
    (reference: fluxJacobian.hpp:612-662)."""
    ns = phys.ns
    N = ns + 4
    t = st.temperature(phys, q)
    rho = st.rho(phys, q)
    mf = st.mixture_fractions(phys, q)
    gm1 = phys.gamma(t, mf) - 1.0
    inv_rho = 1.0 / rho
    vel = st.velocity(phys, q)
    u, v, w = vel
    vmag2 = (vel * vel).sum(dim=0)
    zero = torch.zeros_like(rho)
    one = torch.ones_like(rho)

    rows = [[zero] * N for _ in range(N)]
    for i in range(ns):
        rows[i][i] = one
        rows[ns + 0][i] = -inv_rho * u
        rows[ns + 1][i] = -inv_rho * v
        rows[ns + 2][i] = -inv_rho * w
        rows[ns + 3][i] = 0.5 * gm1 * vmag2
    rows[ns + 0][ns + 0] = inv_rho
    rows[ns + 3][ns + 0] = -gm1 * u
    rows[ns + 1][ns + 1] = inv_rho
    rows[ns + 3][ns + 1] = -gm1 * v
    rows[ns + 2][ns + 2] = inv_rho
    rows[ns + 3][ns + 2] = -gm1 * w
    rows[ns + 3][ns + 3] = gm1 * one
    return rows


def del_prim_del_cons(phys: Physics, q):
    """d(primitive)/d(conservative), (..., N, N)."""
    return _assemble(_del_prim_del_cons_rows(phys, q))


def _tsl_rows(phys: Physics, cfg, q, mu, mut, f1, n, mag, dist, vgrad,
              left: bool):
    """Rows of the TSL viscous Jacobian in PRIMITIVE variables, its
    mag*mu_tot/dist scale factor, and the (d0, d1, fac) turbulence
    diagonal; the species rows are the diffusion rows with more than one
    species and ``cfg['diffusion']`` schmidt, else zero."""
    ns = phys.ns
    N = ns + 4
    scaling = phys.nondim_scaling
    t = st.temperature(phys, q)
    rho = st.rho(phys, q)
    mf = st.mixture_fractions(phys, q)
    mu_s = scaling * mu
    mut_s = scaling * mut
    vel = st.velocity(phys, q)
    vn = (vel * n).sum(dim=0)
    u, v, w = vel
    nx, ny, nz = n
    k = scaling * phys.conductivity(t, mf)
    cp = phys.cp(t, mf)
    kt = mut_s * cp / phys.turb_prandtl() if phys.nturb else 0.0
    mu_tot = mu_s + mut_s

    tau = tau_normal(vgrad, n, mu_tot)
    fac = -1.0 if left else 1.0
    third = 1.0 / 3.0
    zero = torch.zeros_like(rho)

    rows = [[zero] * N for _ in range(N)]
    if ns > 1 and cfg.get("diffusion", "none") != "none":
        dcoeff = mu_s / cfg["schmidt"] + mut_s / cfg["turb_schmidt"]
        hs = phys.species_enthalpy(t)
        for i in range(ns):
            for j in range(ns):
                kron = 1.0 if i == j else 0.0
                rows[i][j] = dcoeff * (kron - mf[i]) / (mu_tot * rho)
            rows[ns + 3][i] = (-(k + kt) * t / (mu_tot * rho)
                               + rows[i][i] * (hs[i] + 0.5 *
                                               (vel * vel).sum(dim=0)))
    else:
        for i in range(ns):
            rows[ns + 3][i] = -(k + kt) * t / (mu_tot * rho)

    one = torch.ones_like(rho)
    rows[ns + 0][ns + 0] = third * nx * nx + 1.0 * one
    rows[ns + 1][ns + 0] = third * nx * ny * one
    rows[ns + 2][ns + 0] = third * nx * nz * one
    rows[ns + 3][ns + 0] = (fac * 0.5 * dist / mu_tot * tau[0]
                            + third * nx * vn + u)
    rows[ns + 0][ns + 1] = third * ny * nx * one
    rows[ns + 1][ns + 1] = third * ny * ny + 1.0 * one
    rows[ns + 2][ns + 1] = third * ny * nz * one
    rows[ns + 3][ns + 1] = (fac * 0.5 * dist / mu_tot * tau[1]
                            + third * ny * vn + v)
    rows[ns + 0][ns + 2] = third * nz * nx * one
    rows[ns + 1][ns + 2] = third * nz * ny * one
    rows[ns + 2][ns + 2] = third * nz * nz + 1.0 * one
    rows[ns + 3][ns + 2] = (fac * 0.5 * dist / mu_tot * tau[2]
                            + third * nz * vn + w)
    rows[ns + 3][ns + 3] = (k + kt) / (mu_tot * rho)

    scale = mag * mu_tot / dist
    d0 = d1 = None
    if phys.nturb:
        model = cfg["turb_model"]
        length = scaling * mag / dist / rho
        if model == "kOmegaWilcox2006":
            mutx = rho * q[phys.it] / q[phys.it + 1]
            d0 = length * (mu + sigma_k(model, f1) * mutx)
            d1 = length * (mu + sigma_w(model, f1) * mutx)
        else:
            d0 = length * (mu + sigma_k(model, f1) * mut)
            d1 = length * (mu + sigma_w(model, f1) * mut)
    return rows, scale, (d0, d1, fac)


def approx_tsl_jacobian(phys: Physics, cfg, q, mu, mut, f1, n, mag, dist,
                        vgrad, left: bool):
    """Approximate thin-shear-layer viscous Jacobian (after Dwight),
    including the primitive -> conservative change of variables
    (reference: fluxJacobian.hpp:665-760).  Returns (flow, turb)."""
    rows, scale, (d0, d1, fac) = _tsl_rows(phys, cfg, q, mu, mut, f1, n,
                                           mag, dist, vgrad, left)
    flow = _assemble(rows) * scale[..., None, None]
    flow = torch.einsum("...ab,...bc->...ac", flow,
                        del_prim_del_cons(phys, q))
    turb = None
    if phys.nturb:
        z = torch.zeros_like(d0)
        turb = fac * _assemble([[d0, z], [z, d1]])
    return flow, turb


def tsl_offdiag_matvec(phys: Physics, cfg, q, mu, mut, f1, n, mag, dist,
                       vgrad, left: bool, du):
    """Channel-first approx_tsl_jacobian applied to du:
    scale * Rows.(dPrim/dCons.du) as two row matvecs.  Returns
    (flow_y, turb_y)."""
    rows, scale, (d0, d1, fac) = _tsl_rows(phys, cfg, q, mu, mut, f1, n,
                                           mag, dist, vgrad, left)
    N = phys.ns + 4
    dp = rows_matvec(_del_prim_del_cons_rows(phys, q), du[:N])
    yf = rows_matvec(rows, dp, scale=scale)
    yt = None
    if phys.nturb:
        yt = fac * torch.stack([d0 * du[phys.it], d1 * du[phys.it + 1]])
    return yf, yt


def turb_src_jacobian(phys: Physics, cfg, q, vol, beta, phi=1.0):
    """2x2 turbulence source Jacobian diag(-2 beta* omega phi,
    -2 beta omega) * vol / scaling (reference: turbulence.cpp:300-330,
    490-520)."""
    inv_scaling = 1.0 / phys.nondim_scaling
    beta_star = (WILCOX["beta_star"]
                 if cfg["turb_model"] == "kOmegaWilcox2006"
                 else SST["beta_star"])
    omega = q[phys.it + 1]
    j00 = -2.0 * beta_star * omega * phi * vol * inv_scaling
    j11 = -2.0 * beta * omega * vol * inv_scaling
    z = torch.zeros_like(j00)
    return _assemble([[j00, z], [z, j11]])


def block_matvec(flow_mat, turb_mat, x, phys: Physics):
    """(..., N, N) x (neq, ...) -> (neq, ...) blockwise."""
    N = phys.ns + 4
    xf = torch.movedim(x[:N], 0, -1)
    out = torch.movedim(torch.einsum("...ab,...b->...a", flow_mat, xf),
                        -1, 0)
    if phys.nturb and turb_mat is not None:
        xt = torch.movedim(x[phys.it:], 0, -1)
        yt = torch.einsum("...ab,...b->...a", turb_mat, xt)
        out = torch.cat([out, torch.movedim(yt, -1, 0)], dim=0)
    elif phys.nturb:
        out = torch.cat([out, x[phys.it:]], dim=0)
    return out


def block_inverse(flow_mat, turb_mat):
    inv_f = torch.linalg.inv(flow_mat)
    inv_t = None if turb_mat is None else torch.linalg.inv(turb_mat)
    return inv_f, inv_t
