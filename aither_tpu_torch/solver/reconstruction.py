"""Face reconstruction: constant, MUSCL (kappa-scheme + limiters) and
fifth-order WENO / WENO-Z on nonuniform widths, plus the 2-point and
4-point central reconstructions the viscous fluxes use.

Port of ``aither_tpu/solver/reconstruction.py`` (reference:
include/reconstruction.hpp:37-381, src/limiter.cpp, utility.cpp:449-485),
term by term in the JAX package's order of operations.
"""

from __future__ import annotations

import torch

EPS = 1.0e-30


def _limiter(name: str, r):
    if name == "none":
        return torch.ones_like(r)
    if name == "minmod":
        return torch.clamp(r, 0.0, 1.0)
    if name == "vanAlbada":
        # the same clip as the JAX package (it keeps r*r finite in float32,
        # where |r| ~ 1/EPS at zero-gradient cells)
        big = 0.25 * torch.finfo(r.dtype).max ** 0.5
        r = torch.clamp(r, -big, big)
        return torch.clamp((r + r * r) / (1.0 + r * r), min=0.0)
    raise ValueError(f"unknown limiter {name!r}")


def muscl(u2, u1, d1, w_u2, w_u1, w_d1, kappa: float, limiter: str):
    """MUSCL reconstruction of the face state from 2 upwind + 1 downwind
    cells with nonuniform-width weighting (reconstruction.hpp:110-155).

    u2/u1/d1: (neq, ...) cell states; w_*: (...) cell widths."""
    d_plus = ((w_u1 + w_u1) / (w_u1 + w_d1))[None]
    d_minus = ((w_u1 + w_u1) / (w_u1 + w_u2))[None]
    r = (EPS + (d1 - u1) * d_plus) / (EPS + (u1 - u2) * d_minus)
    lim = _limiter(limiter, r)
    inv_lim = _limiter(limiter, 1.0 / r) if limiter != "none" else lim
    return u1 + 0.25 * ((u1 - u2) * d_minus) * (
        (1.0 - kappa) * lim + (1.0 + kappa) * r * inv_lim)


def _stencil_width(cw, start, end):
    """sum of cell widths in [start, end), negative if start > end
    (utility.hpp:104-114)."""
    if end > start:
        out = cw[start]
        for i in range(start + 1, end):
            out = out + cw[i]
        return out
    if start > end:
        out = cw[end]
        for i in range(end + 1, start):
            out = out + cw[i]
        return -out
    return 0.0


def _lagrange_coeff(cw, degree, rr, ii):
    """Reconstruction coefficients for a candidate stencil on a nonuniform
    grid (utility.cpp:449-485; Shu ICASE 97-65 eq 2.20). cw is a list of
    width tensors; returns degree+1 coefficient tensors."""
    coeffs = []
    for jj in range(degree + 1):
        acc = 0.0
        for mm in range(jj + 1, degree + 2):
            numer = 0.0
            denom = 1.0
            for ll in range(degree + 2):
                if ll == mm:
                    continue
                prod = 1.0
                for qq in range(degree + 2):
                    if qq != mm and qq != ll:
                        prod = prod * _stencil_width(cw, ii - rr + qq, ii + 1)
                numer = numer + prod
                denom = denom * _stencil_width(cw, ii - rr + ll, ii - rr + mm)
            acc = acc + numer / denom
        coeffs.append(acc * cw[ii - rr + jj])
    return coeffs


def _derivative2nd(x0, x1, x2, y0, y1, y2):
    """(utility.hpp:117-122)"""
    fwd = (y2 - y1) / (0.5 * (x2 + x1))
    bck = (y1 - y0) / (0.5 * (x1 + x0))
    return (fwd - bck) / (0.25 * (x2 + x0) + 0.5 * x1)


def _beta_integral(d1, d2, dx, xl, xh):
    """(reconstruction.hpp:159-185)"""
    def F(x):
        return (d1 * d1 * x + d1 * d2 * x * x + d2 * d2 * x ** 3 / 3.0) * dx \
            + d2 * d2 * x * dx ** 3
    return F(xh) - F(xl)


def _beta0(x0, x1, x2, y0, y1, y2):
    d2 = _derivative2nd(x0, x1, x2, y0, y1, y2)
    d1 = (y2 - y1) / (0.5 * (x2 + x1)) + 0.5 * x2 * d2
    return _beta_integral(d1, d2, x2, -0.5 * x2, 0.5 * x2)


def _beta1(x0, x1, x2, y0, y1, y2):
    d2 = _derivative2nd(x0, x1, x2, y0, y1, y2)
    d1 = (y2 - y1) / (0.5 * (x2 + x1)) - 0.5 * x1 * d2
    return _beta_integral(d1, d2, x1, -0.5 * x1, 0.5 * x1)


def _beta2(x0, x1, x2, y0, y1, y2):
    d2 = _derivative2nd(x0, x1, x2, y0, y1, y2)
    d1 = (y1 - y0) / (0.5 * (x1 + x0)) - 0.5 * x0 * d2
    return _beta_integral(d1, d2, x0, -0.5 * x0, 0.5 * x0)


def weno(u3, u2, u1, d1, d2, w3, w2, w1, wd1, wd2, is_weno_z: bool):
    """5th-order WENO / WENO-Z face reconstruction on nonuniform widths
    (reconstruction.hpp:244-330).  u* upwind, d* downwind states (neq, ...);
    w* the matching cell widths (...)."""
    cwb = [w[None] for w in (w3, w2, w1, wd1, wd2)]

    c0 = _lagrange_coeff(cwb, 2, 2, 2)
    s0 = c0[0] * u3 + c0[1] * u2 + c0[2] * u1
    c1 = _lagrange_coeff(cwb, 2, 1, 2)
    s1 = c1[0] * u2 + c1[1] * u1 + c1[2] * d1
    c2 = _lagrange_coeff(cwb, 2, 0, 2)
    s2 = c2[0] * u1 + c2[1] * d1 + c2[2] * d2

    full = _lagrange_coeff(cwb, 4, 2, 2)
    lw0 = full[0] / c0[0]
    lw1 = full[4] / c2[2]
    lw2 = 1.0 - lw0 - lw1

    b0 = _beta0(w3[None], w2[None], w1[None], u3, u2, u1)
    b1 = _beta1(w2[None], w1[None], wd1[None], u2, u1, d1)
    b2 = _beta2(w1[None], wd1[None], wd2[None], u1, d1, d2)

    if is_weno_z:
        tau5 = torch.abs(b0 - b2)
        eps = 1.0e-40
        nlw0 = lw0 * (1.0 + (tau5 / (eps + b0)) ** 2)
        nlw1 = lw1 * (1.0 + (tau5 / (eps + b1)) ** 2)
        nlw2 = lw2 * (1.0 + (tau5 / (eps + b2)) ** 2)
    else:
        eps = 1.0e-6
        nlw0 = lw0 / (eps + b0) ** 2
        nlw1 = lw1 / (eps + b1) ** 2
        nlw2 = lw2 / (eps + b2) ** 2

    tot = nlw0 + nlw1 + nlw2
    return (nlw0 * s0 + nlw1 * s1 + nlw2 * s2) / tot


def central_coeffs(w_u1, w_d1):
    """(c0, c1) of the 2-point central (Lagrange degree-1) reconstruction
    c0 * d1 + c1 * u1 (reconstruction.hpp:333-347)."""
    c = _lagrange_coeff([w_u1, w_d1], 1, 0, 0)
    return c[0], c[1]


def central(u1, d1, w_u1, w_d1):
    """2-point central (Lagrange degree-1) reconstruction
    (reconstruction.hpp:333-347)."""
    c0, c1 = central_coeffs(w_u1[None], w_d1[None])
    return c0 * d1 + c1 * u1


def central4(u2, u1, d1, d2, w_u2, w_u1, w_d1, w_d2, turb_index=None):
    """4-point central reconstruction; the equations from ``turb_index``
    on (the turbulence variables) fall back to 2-point central
    (reconstruction.hpp:350-381)."""
    cw = [w_u2[None], w_u1[None], w_d1[None], w_d2[None]]
    c = _lagrange_coeff(cw, 3, 1, 1)
    fourth = c[0] * u2 + c[1] * u1 + c[2] * d1 + c[3] * d2
    if turb_index is not None and turb_index < fourth.shape[0]:
        second = central(u1, d1, w_u1, w_d1)
        fourth = torch.cat([fourth[:turb_index], second[turb_index:]])
    return fourth


def reconstruct_faces(prim, widths, axis: int, g: int, n: int, scheme: str,
                      kappa: float, limiter: str):
    """Reconstruct left/right states at the n+1 physical faces along `axis`.

    prim: (neq, NI, NJ, NK) padded primitive tensor
    widths: (NI, NJ, NK) cell widths along `axis`
    Returns (ql, qr) with face-count n+1 along `axis`.

    Face f (padded index g+f) lower state stencil uses cells g+f-1 (upwind1),
    g+f-2 (upwind2), g+f (downwind); mirrored for the upper state
    (reference: procBlock.cpp:397-433)."""
    nf = n + 1

    def cells(off):
        lo = [slice(None)] * prim.dim()
        lo[axis] = slice(g - 1 + off, g - 1 + off + nf)
        return prim[tuple(lo)]

    def wcells(off):
        lo = [slice(None)] * widths.dim()
        lo[axis - 1] = slice(g - 1 + off, g - 1 + off + nf)
        return widths[tuple(lo)]

    if scheme == "constant":
        return cells(0), cells(1)

    if scheme == "muscl":
        ql = muscl(cells(-1), cells(0), cells(1),
                   wcells(-1), wcells(0), wcells(1), kappa, limiter)
        qr = muscl(cells(2), cells(1), cells(0),
                   wcells(2), wcells(1), wcells(0), kappa, limiter)
        return ql, qr

    if scheme in ("weno", "wenoZ"):
        wz = scheme == "wenoZ"
        ql = weno(cells(-2), cells(-1), cells(0), cells(1), cells(2),
                  wcells(-2), wcells(-1), wcells(0), wcells(1), wcells(2), wz)
        qr = weno(cells(3), cells(2), cells(1), cells(0), cells(-1),
                  wcells(3), wcells(2), wcells(1), wcells(0), wcells(-1), wz)
        return ql, qr

    raise ValueError(f"unknown reconstruction scheme {scheme!r}")
