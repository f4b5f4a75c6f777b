"""Face reconstruction: constant and MUSCL (kappa-scheme + limiters), plus
the 2-point central reconstruction the viscous fluxes use.

Port of ``aither_tpu/solver/reconstruction.py:18-88, 164-224``
(reference: include/reconstruction.hpp:37-155, src/limiter.cpp).  WENO,
WENO-Z and centralFourth are not in the port yet (the Solver refuses them).
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

    raise ValueError(f"unknown reconstruction scheme {scheme!r}")
