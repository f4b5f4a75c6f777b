"""Viscous fluxes, face-CV Green-Gauss gradients and the turbulence models.

Port of ``aither_tpu/solver/viscous.py`` for the slice: laminar, WALE
(LES), k-omega Wilcox 2006, SST k-omega 2003 and SST-DES, low-Re and
wall-law walls, any species count with the mixture's transport and, with
``diffusionModel: schmidt``, the species-diffusion fluxes, central or
centralFourth viscous reconstruction.  ``viscous_residual`` has the JAX package's two forms:
the per-iteration one (``need_aux=False``: only the cell-average
gradients the turbulence sources read are accumulated, and the pressure
gradient the LODI boundaries read when ``need_pgrad``; the mass-fraction
gradients are formed per face for the diffusion fluxes, never averaged to
the cells) and the output one (``need_aux=True``: also the cell-average
temperature, density, pressure and mass-fraction gradients and the
per-wall-patch records ``wall_out`` of the function files).
Reference: src/procBlock.cpp:1233-1879 CalcViscFluxI/J/K, :5173-5955
CalcGradsI/J/K, src/turbulence.cpp.

Gradients use the face-centered auxiliary control volume: per face the CV
spans the two adjacent cells; transverse CV faces average 4 cells; each
face gradient is also accumulated to the two adjacent cells with weight
1/6 for the source terms.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid.geometry import AX
from ..physics.models import Physics
from . import state as st
from .reconstruction import central4, central_coeffs

EPS = 1.0e-30

WILCOX = dict(gamma=0.52, beta_star=0.09, sigma=0.5, sigma_star=0.6,
              sigma_d0=0.125, beta0=0.0708, clim=0.875, prt=8.0 / 9.0)
SST = dict(beta_star=0.09, sigma_k1=0.85, sigma_k2=1.0, sigma_w1=0.5,
           sigma_w2=0.856, beta1=0.075, beta2=0.0828, gamma1=5.0 / 9.0,
           gamma2=0.44, a1=0.31, prt=0.9, k_prod2dest=10.0)
DES = dict(cdes1=0.78, cdes2=0.61)
WALE = dict(cw=0.544)


def turb_prandtl(model: str) -> float:
    return WILCOX["prt"] if model == "kOmegaWilcox2006" else SST["prt"]


def wall_beta(model: str) -> float:
    return WILCOX["beta0"] if model == "kOmegaWilcox2006" else SST["beta1"]


def sigma_k(model: str, f1):
    if model == "kOmegaWilcox2006":
        return WILCOX["sigma_star"]
    return f1 * SST["sigma_k1"] + (1.0 - f1) * SST["sigma_k2"]


def sigma_w(model: str, f1):
    if model == "kOmegaWilcox2006":
        return WILCOX["sigma"]
    return f1 * SST["sigma_w1"] + (1.0 - f1) * SST["sigma_w2"]


def _strain(vgrad):
    """mean strain rate 0.5(G + G^T); vgrad[a][b] = d v_b / d x_a"""
    return 0.5 * (vgrad + vgrad.transpose(0, 1))


def _ddot_trans(a, b):
    """A : B^T double dot = sum_ij A_ij B_ij (tensor.DoubleDotTrans)."""
    return (a * b).sum(dim=(0, 1))


def _identity_like(vgrad):
    """3x3 identity broadcast over vgrad's (3, 3, ...) point axes"""
    return torch.eye(3, dtype=vgrad.dtype, device=vgrad.device).reshape(
        (3, 3) + (1,) * (vgrad.dim() - 2))


def eddy_visc_and_blending(phys: Physics, model: str, q, vgrad, kgrad, wgrad,
                           mu, wall_dist, length):
    """(mut, f1, f2) at a point set (reference: turbulence.cpp:208-700).
    ``kgrad`` / ``wgrad`` are read by the SST models only, ``length`` (the
    face length) by WALE only, which has no turbulence rows in ``q``."""
    scaling = phys.nondim_scaling
    r = st.rho(phys, q)
    if model == "kOmegaWilcox2006":
        tke = q[phys.it]
        omega = q[phys.it + 1]
        trace = vgrad[0, 0] + vgrad[1, 1] + vgrad[2, 2]
        s_hat = _strain(vgrad) - (trace / 3.0)[None, None] * _identity_like(
            vgrad)
        omega_tilda = torch.maximum(
            omega, scaling * WILCOX["clim"]
            * torch.sqrt(2.0 * _ddot_trans(s_hat, s_hat)
                         / WILCOX["beta_star"]))
        mut = r * tke / omega_tilda
        return mut, torch.ones_like(mut), torch.zeros_like(mut)
    if model in ("sst2003", "sstdes"):
        tke = q[phys.it]
        omega = q[phys.it + 1]
        alpha1 = scaling * torch.sqrt(tke) / (
            SST["beta_star"] * omega * (wall_dist + EPS))
        alpha2 = scaling * scaling * 500.0 * mu / (
            (wall_dist + EPS) ** 2 * r * omega)
        cdkw = torch.clamp(
            2.0 * r * SST["sigma_w2"] / omega * (kgrad * wgrad).sum(dim=0),
            min=1.0e-10)
        alpha3 = 4.0 * r * SST["sigma_w2"] * tke / (
            cdkw * (wall_dist + EPS) ** 2)
        f1 = torch.tanh(torch.minimum(torch.maximum(alpha1, alpha2),
                                      alpha3) ** 4)
        f2 = torch.tanh(torch.maximum(2.0 * alpha1, alpha2) ** 2)
        sr = _strain(vgrad)
        mean_sr = torch.sqrt(2.0 * _ddot_trans(sr, sr))
        mut = r * SST["a1"] * tke / torch.maximum(
            SST["a1"] * omega, scaling * mean_sr * f2)
        return mut, f1, f2
    if model == "wale":
        sd = _wale_sigma_d(vgrad)
        sr = _strain(vgrad)
        num = _ddot_trans(sd, sd) ** 1.5
        den = (_ddot_trans(sr, sr) ** 2.5
               + _ddot_trans(sd, sd) ** 1.25 + EPS)
        # NOTE: the reference returns (cw*length)^2 * velGradTerm with NO
        # rho and NO 1/nondim-scaling factor (turbulence.cpp:967-990) --
        # unlike every RANS model's rho*k/omega-form mut -- so in nondim
        # units its SGS viscosity is ~scaling x smaller than the
        # physically-scaled form.  Replicated verbatim for golden parity
        # (the couette-wale goldens sit within 1% of plain couette).
        mut = (WALE["cw"] * length) ** 2 * num / den
        return mut, torch.ones_like(mut), torch.zeros_like(mut)
    raise ValueError(f"unknown turbulence model {model!r}")


def _wale_sigma_d(vgrad):
    """traceless symmetric square of the velocity gradient (WALE)"""
    g2 = torch.stack([torch.stack([
        vgrad[a, 0] * vgrad[0, c] + vgrad[a, 1] * vgrad[1, c]
        + vgrad[a, 2] * vgrad[2, c] for c in range(3)]) for a in range(3)])
    sym = 0.5 * (g2 + g2.transpose(0, 1))
    trace = g2[0, 0] + g2[1, 1] + g2[2, 2]
    return sym - (trace / 3.0)[None, None] * _identity_like(vgrad)


def wilcox_beta(phys: Physics, q, vgrad):
    """beta = beta0 * FBeta with the guarded vortex-stretching invariant
    (reference: turbulence.cpp:199-230)."""
    w = WILCOX
    omega = q[phys.it + 1]
    trace = vgrad[0, 0] + vgrad[1, 1] + vgrad[2, 2]
    vort = 0.5 * (vgrad - vgrad.transpose(0, 1))
    strain_ki = 0.5 * (vgrad + vgrad.transpose(0, 1)
                       - trace[None, None] * _identity_like(vgrad))
    num = 0.0
    scale = 0.0
    for a in range(3):
        for c in range(3):
            v2 = (vort[a, 0] * vort[0, c] + vort[a, 1] * vort[1, c]
                  + vort[a, 2] * vort[2, c])
            term = v2 * strain_ki[a, c]
            num = num + term
            scale = scale + torch.abs(term)
    num = torch.where(torch.abs(num) <= 1.0e-10 * scale,
                      torch.zeros_like(num), num)
    xw = torch.abs(num / (w["beta_star"] * omega) ** 3)
    fbeta = (1.0 + 85.0 * xw) / (1.0 + 100.0 * xw)
    return w["beta0"] * fbeta


def turb_source(phys: Physics, model: str, q, vgrad, kgrad, wgrad, mut, f1,
                f2, width):
    """(src_k, src_w, src_spec_rad) per cell
    (reference: turbulence.cpp:244-320, 422-470, 560-610)."""
    scaling = phys.nondim_scaling
    inv_scaling = 1.0 / scaling
    r = st.rho(phys, q)
    tke = q[phys.it]
    omega = q[phys.it + 1]

    # Boussinesq Reynolds stress : velGrad
    lam = -2.0 / 3.0 * mut
    trace = vgrad[0, 0] + vgrad[1, 1] + vgrad[2, 2]
    tau = (lam * trace - 2.0 / 3.0 * r * tke)[None, None] \
        * _identity_like(vgrad) \
        + mut[None, None] * (vgrad + vgrad.transpose(0, 1))
    rs_ddot = _ddot_trans(tau, vgrad)

    if model == "kOmegaWilcox2006":
        w = WILCOX
        # beta = beta0 * FBeta; the vortex-stretching invariant needs a
        # cancellation guard (it is exactly zero in 2D flows and fused
        # arithmetic otherwise leaves amplified roundoff) -- see wilcox_beta
        beta = wilcox_beta(phys, q, vgrad)
        tke_dest = inv_scaling * w["beta_star"] * r * tke * omega
        omg_dest = inv_scaling * beta * r * omega * omega
        tke_prod = torch.clamp(scaling * rs_ddot, min=0.0)
        omg_prod = torch.clamp(w["gamma"] * omega / tke * tke_prod, min=0.0)
        kdotw = (kgrad * wgrad).sum(dim=0)
        sigma_d = torch.where(kdotw <= 0.0, torch.zeros_like(kdotw),
                              torch.full_like(kdotw, w["sigma_d0"]))
        omg_cd = scaling * sigma_d * r / omega * kdotw
        src_k = tke_prod - tke_dest
        src_w = omg_prod - omg_dest + omg_cd
        src_rad = -2.0 * w["beta_star"] * omega * inv_scaling
        return src_k, src_w, src_rad

    if model in ("sst2003", "sstdes"):
        s = SST
        cdkw = torch.clamp(
            2.0 * r * s["sigma_w2"] / omega * (kgrad * wgrad).sum(dim=0),
            min=1.0e-10)
        gamma = f1 * s["gamma1"] + (1.0 - f1) * s["gamma2"]
        beta = f1 * s["beta1"] + (1.0 - f1) * s["beta2"]
        if model == "sstdes":
            cdes = f1 * DES["cdes1"] + (1.0 - f1) * DES["cdes2"]
            tls = torch.sqrt(tke) / (s["beta_star"] * omega) * scaling
            phi = torch.clamp((1.0 - f2) * tls / (cdes * width), min=1.0)
            # NOTE: the reference's DES tke destruction OMITS the beta*
            # prefactor plain SST applies -- turbSstDes::CalcTurbSrc uses
            # invScaling * TkeDestruction(state, phi) = invScaling*rho*k*
            # omega*phi (turbulence.cpp:893-895) where turbKWSst uses
            # invScaling * betaStar * TkeDestruction(state)
            # (turbulence.cpp:744-746).  Replicated for golden parity.
            tke_dest = inv_scaling * r * tke * omega * phi
        else:
            tke_dest = inv_scaling * s["beta_star"] * r * tke * omega
        omg_dest = inv_scaling * beta * r * omega * omega
        tke_prod = torch.clamp(
            torch.minimum(scaling * rs_ddot, s["k_prod2dest"] * tke_dest),
            min=0.0)
        omg_prod = torch.clamp(gamma * r / mut * tke_prod, min=0.0)
        omg_cd = scaling * (1.0 - f1) * cdkw
        src_k = tke_prod - tke_dest
        src_w = omg_prod - omg_dest + omg_cd
        if model == "sstdes":
            # spec rad from max |diag| of src jacobian with beta2.  NOTE
            # the reference forwards the raw CELL WIDTH as the phi
            # argument here (procBlock.cpp:6005-6007 passes
            # phi=MaxCellWidth into SrcSpecRad; turbulence.cpp:925-935
            # plugs it straight into TurbSrcJac's destruction
            # multiplier) -- replicated for trajectory parity.
            j00 = -2.0 * s["beta_star"] * omega * width * inv_scaling
            j11 = -2.0 * s["beta2"] * omega * inv_scaling
            src_rad = -torch.maximum(torch.abs(j00), torch.abs(j11))
        else:
            src_rad = -2.0 * s["beta_star"] * omega * inv_scaling
        return src_k, src_w, src_rad

    raise ValueError(f"no source terms for turbulence model {model!r}")


# ---------------------------------------------------------------------------
# gradients


# per-face static channels of one direction, in this order (the values of
# the JAX package's prepack_march_static, laid out physically): the six
# face-CV area vectors, the CV volume, the face unit normal and area, the
# central interpolation coefficients (qf = c0 q_hi + c1 q_lo) and the
# face wall distance; for WALE one more, the face length 0.5 (w_lo + w_hi)
# of the two cells' widths along the direction
FACE_CHANNELS = (("adu", 3), ("adl", 3), ("a1u", 3), ("a1l", 3), ("a2u", 3),
                 ("a2l", 3), ("vcv", 1), ("n", 3), ("mag", 1), ("c0", 1),
                 ("c1", 1), ("wdf", 1))
LEN_CHANNEL = ("len", 1)
NFACE = sum(k for _, k in FACE_CHANNELS)      # 26; 27 with the face length


def needs_face_length(cfg) -> bool:
    """Only WALE reads the face length; the other models' statics (and the
    fused kernel's bound) stay without it."""
    return cfg.get("turb_model") == "wale"


def viscous_statics(block, with_len: bool = False):
    """Static face and cell geometry of the viscous residual, built once
    per block from its geometry and kept in ``block.cache``.

    ``{"face": {d: (26, *F_d)}, "cell": (4, ni, nj, nk)}``: F_d is the
    grid of the n_d + 1 physical faces along d by the physical cells
    across (channels ``FACE_CHANNELS``, and with ``with_len`` the face
    length as a 27th); the cell channels are the volume and, per direction
    i, j, k, the mean area of the cell's two faces.  Both the plain
    residual below and the CUDA kernel (``kernels/viscous_march.py``) read
    it."""
    key = "viscous_statics"
    have = block.cache.get(key)
    if have is None or (with_len and have["face"]["i"].shape[0] == NFACE):
        block.cache[key] = have = _build_statics(block, with_len)
    return have


def face_fields(statics, d: str) -> dict:
    """name -> view of direction d's face statics ((3, *F) or (*F))."""
    arr = statics["face"][d]
    channels = FACE_CHANNELS + ((LEN_CHANNEL,) if arr.shape[0] > NFACE
                                else ())
    out, c = {}, 0
    for name, k in channels:
        out[name] = arr[c:c + k] if k > 1 else arr[c]
        c += k
    return out


def _build_statics(block, with_len: bool = False):
    g = block.g
    geom = block.geom
    dims = {"i": block.ni, "j": block.nj, "k": block.nk}
    area = {d: geom[f"n_{d}"] * geom[f"mag_{d}"][None] for d in "ijk"}
    wd_all = geom["wall_dist"]
    face = {}
    fmag = {}
    for d in "ijk":
        ax = 1 + AX[d]
        n = dims[d]
        nf = n + 1
        d1, d2 = [x for x in "ijk" if x != d]

        def fvec(dd, off_d, off_own):
            """area vector of face array dd; off_d shifts along d, off_own
            along dd's own axis."""
            sl = [slice(None)] * 4
            for a, x in enumerate("ijk"):
                if x == d and dd == d:
                    sl[1 + a] = slice(g + off_d, g + off_d + nf)
                elif x == d:
                    sl[1 + a] = slice(g - 1 + off_d, g - 1 + off_d + nf)
                elif x == dd:
                    sl[1 + a] = slice(g + off_own, g + off_own + dims[x])
                else:
                    sl[1 + a] = slice(g, g + dims[x])
            return area[dd][tuple(sl)]

        def cellslab(arr, off_d):
            sl = [slice(None)] * 3
            sl[AX[d]] = slice(g - 1 + off_d, g - 1 + off_d + nf)
            sl[AX[d1]] = slice(g, g + dims[d1])
            sl[AX[d2]] = slice(g, g + dims[d2])
            return arr[tuple(sl)]

        f = {}
        # normal-direction CV faces: avg of face f with f+-1
        f["adu"] = 0.5 * (fvec(d, 0, 0) + fvec(d, 1, 0))
        f["adl"] = 0.5 * (fvec(d, 0, 0) + fvec(d, -1, 0))
        # transverse CV faces: avg over the two cells (f-1, f) of their
        # dd-faces
        f["a1u"] = 0.5 * (fvec(d1, 1, 1) + fvec(d1, 0, 1))
        f["a1l"] = 0.5 * (fvec(d1, 1, 0) + fvec(d1, 0, 0))
        f["a2u"] = 0.5 * (fvec(d2, 1, 1) + fvec(d2, 0, 1))
        f["a2l"] = 0.5 * (fvec(d2, 1, 0) + fvec(d2, 0, 0))
        vol = geom["vol"]
        f["vcv"] = 0.5 * (cellslab(vol, 0) + cellslab(vol, 1))
        fsl = [slice(None)] * 4
        fsl[ax] = slice(g, g + nf)
        fsl[1 + AX[d1]] = slice(g, g + dims[d1])
        fsl[1 + AX[d2]] = slice(g, g + dims[d2])
        f["n"] = geom[f"n_{d}"][tuple(fsl)]
        f["mag"] = geom[f"mag_{d}"][tuple(fsl[1:])]
        w_all = geom[f"width_{d}"]
        f["c0"], f["c1"] = central_coeffs(cellslab(w_all, 0),
                                          cellslab(w_all, 1))
        wdf = f["c0"] * cellslab(wd_all, 1) + f["c1"] * cellslab(wd_all, 0)
        f["wdf"] = torch.where((wdf < 0.0) & (wdf > -1.0e-10), 0.0, wdf)
        f["len"] = 0.5 * (cellslab(w_all, 0) + cellslab(w_all, 1))
        channels = FACE_CHANNELS + ((LEN_CHANNEL,) if with_len else ())
        face[d] = torch.cat([f[name].reshape((k,) + f["mag"].shape)
                             for name, k in channels]).contiguous()
        lo, hi = _face_lohi(AX[d], n)
        fmag[d] = 0.5 * (f["mag"][lo] + f["mag"][hi])
    P = tuple(slice(g, g + dims[d]) for d in "ijk")
    cell = torch.stack([geom["vol"][P]] + [fmag[d] for d in "ijk"])
    return {"face": face, "cell": cell.contiguous()}


def face_cv_gradients(phys: Physics, block, prim, t_all, d: str,
                      need_mix=False, need_pgrad=False, need_aux=False):
    """Face-centered-CV Green-Gauss gradients along direction d: 'vel'
    (3, 3, nf...) [a][b] = d v_b / d x_a, 'temp' (3, nf...), with
    ``need_aux`` 'rho' (3, nf...), with ``need_aux`` or ``need_pgrad``
    'press' (3, nf...), for RANS 'tke' and 'omega' and,
    with ``need_mix`` and more than one species, 'mix': the mass
    fractions' gradients, a list of ns (3, nf...).
    Shapes trimmed to physical transverse extents, nf = n+1 faces along
    d."""
    g = block.g
    dims = {"i": block.ni, "j": block.nj, "k": block.nk}
    n = dims[d]
    ax = 1 + AX[d]
    nf = n + 1
    d1, d2 = [x for x in "ijk" if x != d]
    sf = face_fields(viscous_statics(block), d)
    a_du, a_dl = sf["adu"], sf["adl"]
    a_1u, a_1l = sf["a1u"], sf["a1l"]
    a_2u, a_2l = sf["a2u"], sf["a2l"]
    vol_cv = sf["vcv"]

    def cells(off_d, off1=0, off2=0):
        """cell slab at (face-1+off_d) along d with transverse offsets
        (reads ghost neighbors at transverse boundaries)."""
        sl = [slice(None)] * 4
        sl[ax] = slice(g - 1 + off_d, g - 1 + off_d + nf)
        sl[1 + AX[d1]] = slice(g + off1, g + off1 + dims[d1])
        sl[1 + AX[d2]] = slice(g + off2, g + off2 + dims[d2])
        return prim[tuple(sl)]

    def tcells(off_d, off1=0, off2=0):
        sl = [slice(None)] * 3
        sl[ax - 1] = slice(g - 1 + off_d, g - 1 + off_d + nf)
        sl[AX[d1]] = slice(g + off1, g + off1 + dims[d1])
        sl[AX[d2]] = slice(g + off2, g + off2 + dims[d2])
        return t_all[tuple(sl)]

    def face_vals(q_lo, q_hi, qs):
        v_1u = 0.25 * (q_lo + q_hi + qs(1, 1, 0) + qs(0, 1, 0))
        v_1l = 0.25 * (q_lo + q_hi + qs(1, -1, 0) + qs(0, -1, 0))
        v_2u = 0.25 * (q_lo + q_hi + qs(1, 0, 1) + qs(0, 0, 1))
        v_2l = 0.25 * (q_lo + q_hi + qs(1, 0, -1) + qs(0, 0, -1))
        return v_1l, v_1u, v_2l, v_2u

    def scalar_grad_from(q_lo, q_hi, qs):
        """Green-Gauss: sum over CV faces of v*A / vol (ScalarGradGG)."""
        v1l, v1u, v2l, v2u = face_vals(q_lo, q_hi, qs)
        num = (q_hi[None] * a_du - q_lo[None] * a_dl
               + v1u[None] * a_1u - v1l[None] * a_1l
               + v2u[None] * a_2u - v2l[None] * a_2l)
        return num / vol_cv[None]

    out = {}
    vel_lo = cells(0)[phys.mx:phys.mx + 3]
    vel_hi = cells(1)[phys.mx:phys.mx + 3]

    def vel_at(od, o1, o2):
        return cells(od, o1, o2)[phys.mx:phys.mx + 3]

    v1l, v1u, v2l, v2u = face_vals(vel_lo, vel_hi, vel_at)
    vg = (vel_hi[None] * a_du[:, None] - vel_lo[None] * a_dl[:, None]
          + v1u[None] * a_1u[:, None] - v1l[None] * a_1l[:, None]
          + v2u[None] * a_2u[:, None] - v2l[None] * a_2l[:, None])
    out["vel"] = vg / vol_cv[None, None]

    if need_aux:
        out["rho"] = scalar_grad_from(
            cells(0)[:phys.ns].sum(dim=0), cells(1)[:phys.ns].sum(dim=0),
            lambda *o: cells(*o)[:phys.ns].sum(dim=0))
    if need_aux or need_pgrad:
        out["press"] = scalar_grad_from(cells(0)[phys.ie], cells(1)[phys.ie],
                                        lambda *o: cells(*o)[phys.ie])
    out["temp"] = scalar_grad_from(tcells(0), tcells(1), tcells)
    if phys.nturb:
        out["tke"] = scalar_grad_from(
            cells(0)[phys.it], cells(1)[phys.it],
            lambda *o: cells(*o)[phys.it])
        out["omega"] = scalar_grad_from(
            cells(0)[phys.it + 1], cells(1)[phys.it + 1],
            lambda *o: cells(*o)[phys.it + 1])
    if phys.ns > 1 and need_mix:
        mix = []
        for ss in range(phys.ns):
            def mf(od, o1=0, o2=0, ss=ss):
                c = cells(od, o1, o2)
                return c[ss] / c[:phys.ns].sum(dim=0)
            mix.append(scalar_grad_from(mf(0), mf(1), mf))
        out["mix"] = mix
    return out


# ---------------------------------------------------------------------------
# viscous flux assembly


def tau_normal(vgrad, n, mu_eff):
    """lambda*tr(G)*n + mu*(G+G^T).n (reference: utility.cpp:426-436)."""
    lam = -2.0 / 3.0 * mu_eff
    trace = vgrad[0, 0] + vgrad[1, 1] + vgrad[2, 2]
    sym = vgrad + vgrad.transpose(0, 1)
    matvec = torch.stack([sym[a, 0] * n[0] + sym[a, 1] * n[1]
                          + sym[a, 2] * n[2] for a in range(3)])
    return lam[None] * trace[None] * n + mu_eff[None] * matvec


def _face_lohi(axd, n):
    """3-tuples selecting the lower/upper face of each cell along spatial
    axis `axd` (0..2); apply to the last 3 dims."""
    lo = [slice(None)] * 3
    hi = [slice(None)] * 3
    lo[axd] = slice(0, n)
    hi[axd] = slice(1, n + 1)
    return tuple(lo), tuple(hi)


def _wall_face_mask(block, d: str, nf: int):
    """1.0 on the faces of viscousWall boundaries along d, else 0.0, shaped
    like per-face scalars (nf along d, ijk order), cached on the block:
    species diffusion is zeroed there (the JAX package's
    ``_reorder_face_mask``, per the CalcWallFlux path)."""
    key = ("wall_face_mask", d)
    if key not in block.cache:
        dims = {"i": block.ni, "j": block.nj, "k": block.nk}
        shape = [dims[x] for x in "ijk"]
        shape[AX[d]] = nf
        mask = np.zeros(shape)
        for spec in block.surfaces:
            if spec.bc_type != "viscousWall" or spec.direction != d:
                continue
            sl = [None, None, None]
            sl[AX[d]] = 0 if spec.lower else dims[d]
            taxes = [a for a in range(3) if a != AX[d]]
            for a, (lo, hi) in zip(taxes, spec.patch):
                sl[a] = slice(lo - block.g, hi - block.g)
            mask[tuple(sl)] = 1.0
        geom = block.geom["vol"]
        block.cache[key] = torch.as_tensor(mask, dtype=geom.dtype,
                                           device=geom.device)
    return block.cache[key]


def _cellslab(block, d: str, arr, off_d: int, eqdim: bool = True):
    """the n_d + 1 cells at (face - 1 + off_d) along d, physical across
    (with a leading equation axis unless ``eqdim`` is False)"""
    g = block.g
    dims = dict(i=block.ni, j=block.nj, k=block.nk)
    d1, d2 = [x for x in "ijk" if x != d]
    sl = [slice(None)] * (4 if eqdim else 3)
    o = 1 if eqdim else 0
    sl[o + AX[d]] = slice(g - 1 + off_d, g + off_d + dims[d])
    sl[o + AX[d1]] = slice(g, g + dims[d1])
    sl[o + AX[d2]] = slice(g, g + dims[d2])
    return arr[tuple(sl)]


def has_wall_law(block) -> bool:
    """whether the block has a viscousWall surface with the wall law"""
    return any(spec.bc_type == "viscousWall" and spec.data is not None
               and spec.data.wall_law for spec in block.surfaces)


def _wall_law_slabs(block, d: str, wall_data):
    """(spec, face index tuple, sign) of the wall-law viscousWall surfaces
    on axis d that have wall-law values in ``wall_data`` (reference:
    procBlock.cpp:1270-1305): the face index is 0 (lower) or n_d (upper)
    along d, the patch across; the sign is +1 on a lower surface, -1 on an
    upper one."""
    if not wall_data:
        return []
    g = block.g
    n = {"i": block.ni, "j": block.nj, "k": block.nk}[d]
    out = []
    for spec in block.surfaces:
        if (spec.bc_type != "viscousWall" or spec.direction != d
                or spec.data is None or not spec.data.wall_law
                or id(spec) not in wall_data):
            continue
        sl = [None, None, None]
        sl[AX[d]] = 0 if spec.lower else n
        taxes = [a for a in range(3) if a != AX[d]]
        for a, (lo, hi) in zip(taxes, spec.patch):
            sl[a] = slice(lo - g, hi - g)
        out.append((spec, tuple(sl), 1.0 if spec.lower else -1.0))
    return out


def face_terms(phys: Physics, cfg, block, prim, t_all, mu_all, d: str,
               wall_data=None, need_pgrad=False, need_aux=False):
    """The faces of direction d (n_d + 1 along d by the physical cells
    across) of ``viscous_residual``: a dict of 'fa' (neq, *F), the flux
    times the face area, the face-CV gradients 'grads'
    (``face_cv_gradients``, with 'press' for ``need_pgrad`` and the output
    fields for ``need_aux``), the face state 'qf' and 'muf', 'mut', 'f1'
    and 'f2' (zeros without turbulence), the unit normal 'n' and area
    'mag', the shear stress 'tau' (3, *F), and the conductivities 'k_eff'
    and 'kt' (0.0 without turbulence) the wall records read.  Elementwise
    over the faces: the CUDA kernel (``kernels/viscous_march.py``)
    evaluates each face with the same expressions.  On the faces of a
    wall-law surface with values in ``wall_data`` (the viscous ghost
    pass's, by ``id(spec)``) where the wall law holds (y+ >= 10), the
    viscosity, eddy viscosity, f1 = f2 = 1, shear stress, energy flux and
    turbulence fluxes are the wall law's (reference:
    procBlock.cpp:1286-1294, viscousFlux.cpp:213-252)."""
    model = cfg["turb_model"]
    is_rans = phys.nturb > 0
    is_turb = cfg.get("turbulent", is_rans)
    diffusion = phys.ns > 1 and cfg.get("diffusion", "none") != "none"
    scaling = phys.nondim_scaling
    prt = turb_prandtl(model)
    nf = dict(i=block.ni, j=block.nj, k=block.nk)[d] + 1
    grads = face_cv_gradients(phys, block, prim, t_all, d,
                              need_mix=diffusion or need_aux,
                              need_pgrad=need_pgrad, need_aux=need_aux)
    sf = face_fields(viscous_statics(block, needs_face_length(cfg)), d)

    if cfg.get("viscous_recon", "central") == "centralFourth":
        # 4-point central face state (the turbulence variables 2-point)
        # and viscosity; the wall distance stays 2-point (aither_tpu
        # viscous.py:550-563)
        w_all = block.geom[f"width_{d}"]
        cs = [_cellslab(block, d, prim, o) for o in (-1, 0, 1, 2)]
        ms = [_cellslab(block, d, mu_all, o, False)[None]
              for o in (-1, 0, 1, 2)]
        ws = [_cellslab(block, d, w_all, o, False) for o in (-1, 0, 1, 2)]
        qf = central4(*cs, *ws, turb_index=phys.it if is_rans else None)
        muf = central4(*ms, *ws)[0]
    else:
        c0, c1 = sf["c0"], sf["c1"]
        qf = (c0[None] * _cellslab(block, d, prim, 1)
              + c1[None] * _cellslab(block, d, prim, 0))
        muf = (c0 * _cellslab(block, d, mu_all, 1, False)
               + c1 * _cellslab(block, d, mu_all, 0, False))
    wdf = sf["wdf"]
    if is_rans:
        tmin = phys.turb_min()
        qf = torch.cat([qf[:phys.it],
                        torch.clamp(qf[phys.it], min=tmin[0])[None],
                        torch.clamp(qf[phys.it + 1], min=tmin[1])[None],
                        qf[phys.it + 2:]])

    vgrad = grads["vel"]
    tgrad = grads["temp"]
    mutf = torch.zeros_like(muf)
    f1f = torch.zeros_like(muf)
    f2f = torch.zeros_like(muf)
    if is_turb:
        mutf, f1f, f2f = eddy_visc_and_blending(
            phys, model, qf, vgrad, grads.get("tke"), grads.get("omega"),
            muf, wdf, sf.get("len"))

    wl_slabs = _wall_law_slabs(block, d, wall_data)
    if wl_slabs:
        # wall-law faces use the wall viscosity / eddy viscosity and
        # f1 = f2 = 1 for spectral radii and Jacobians
        muf, mutf, f1f, f2f = (x.clone() for x in (muf, mutf, f1f, f2f))
        for spec, sl, _ in wl_slabs:
            wv = wall_data[id(spec)]
            lr = wv["low_re"]
            muf[sl] = torch.where(lr, muf[sl], (1.0 / scaling) * wv["mu"])
            mutf[sl] = torch.where(lr, mutf[sl],
                                   (1.0 / scaling) * wv["mut"])
            f1f[sl] = torch.where(lr, f1f[sl], 1.0)
            f2f[sl] = torch.where(lr, f2f[sl], 1.0)

    # face unit normals and areas at physical faces
    nvec, mag = sf["n"], sf["mag"]

    mu_s = scaling * muf
    mut_s = scaling * mutf
    tf = st.temperature(phys, qf)

    # species diffusion (zeroed at viscousWall faces)
    species = torch.zeros_like(muf)[None].expand(phys.ns, *muf.shape)
    if diffusion:
        dcoeff = mu_s / cfg["schmidt"] + mut_s / cfg["turb_schmidt"]
        raw = [dcoeff * (grads["mix"][ss] * nvec).sum(dim=0)
               for ss in range(phys.ns)]
        pos = sum(torch.clamp(r_, min=0.0) for r_ in raw)
        neg = sum(-torch.clamp(r_, max=0.0) for r_ in raw)
        pos_fac = torch.where(pos > neg, neg / (pos + EPS), 1.0)
        neg_fac = torch.where(neg > pos, pos / (neg + EPS), 1.0)
        hs = phys.species_enthalpy(tf)
        wall = _wall_face_mask(block, d, nf)
        h_term = torch.zeros_like(muf)
        fs = []
        for ss in range(phys.ns):
            f_ss = raw[ss] * torch.where(raw[ss] > 0.0, pos_fac, neg_fac)
            f_ss = f_ss * (1.0 - wall)
            fs.append(f_ss)
            h_term = h_term + f_ss * hs[ss]
        species = torch.stack(fs)

    tau = tau_normal(vgrad, nvec, mu_s + mut_s)
    mff = st.mixture_fractions(phys, qf)
    k_eff = scaling * phys.conductivity(tf, mff)
    cp = phys.cp(tf, mff)
    kt = mut_s * cp / prt if is_turb else 0.0
    velf = st.velocity(phys, qf)
    e_flux = ((tau * velf).sum(dim=0)
              + (k_eff + kt) * (tgrad * nvec).sum(dim=0))
    if diffusion:
        e_flux = e_flux + h_term
    turb = []
    if is_rans:
        mutt = mut_s
        if model == "kOmegaWilcox2006":
            # unlimited eddy viscosity for turb diffusion
            mutt = scaling * st.rho(phys, qf) * qf[phys.it] \
                / qf[phys.it + 1]
        kgn = (grads["tke"] * nvec).sum(dim=0)
        wgn = (grads["omega"] * nvec).sum(dim=0)
        turb = [(mu_s + sigma_k(model, f1f) * mutt) * kgn,
                (mu_s + sigma_w(model, f1f) * mutt) * wgn]
    if wl_slabs:
        # prescribed wall-law shear stress / heat flux / turbulence
        # diffusion (reference: viscousFlux.cpp:213-252; tau's sign
        # flipped on upper surfaces, wallLaw.cpp:83-85)
        tau, e_flux = tau.clone(), e_flux.clone()
        turb = [t.clone() for t in turb]
        for spec, sl, sgn in wl_slabs:
            wv = wall_data[id(spec)]
            lr = wv["low_re"]
            tsl = (slice(None),) + sl
            tau_w = sgn * wv["tau"]
            tau[tsl] = torch.where(lr[None], tau[tsl], tau_w)
            vel_wall = torch.tensor(spec.data.velocity, dtype=tau.dtype,
                                    device=tau.device).reshape(3, 1, 1)
            e_wl = (tau_w * vel_wall).sum(dim=0) + wv["q"]
            e_flux[sl] = torch.where(lr, e_flux[sl], e_wl)
            if is_rans:
                tk_wl = (wv["mu"] + sigma_k(model, 1.0) * wv["mut"]) \
                    * kgn[sl]
                tw_wl = (wv["mu"] + sigma_w(model, 1.0) * wv["mut"]) \
                    * wgn[sl]
                turb[0][sl] = torch.where(lr, turb[0][sl], tk_wl)
                turb[1][sl] = torch.where(lr, turb[1][sl], tw_wl)
    rows = [species, tau, e_flux[None]] + [t[None] for t in turb]
    fa = torch.cat(rows) * mag[None]
    return dict(fa=fa, grads=grads, qf=qf, muf=muf, mut=mutf, f1=f1f,
                f2=f2f, n=nvec, mag=mag, tau=tau, k_eff=k_eff, kt=kt)


def _wall_records(phys: Physics, block, d: str, faces, wall_data):
    """{id(spec): record} of the viscousWall surfaces on axis d from the
    faces of ``face_terms``: shear stress 'tau' (3, n1, n2), heat flux
    'q', 'rho', 't', 'mu', 'mut', 'u_star', 'yplus' (the adjacent cell's
    wall distance) and, for RANS, 'tke' / 'sdr' (else None).  On a
    wall-law surface the faces where the wall law holds take the wall
    law's values from ``wall_data`` (reference: procBlock.cpp:1340-1380
    CalcWallFlux storage, wallData.hpp:40-115)."""
    g = block.g
    dims = dict(i=block.ni, j=block.nj, k=block.nk)
    is_rans = phys.nturb > 0
    scaling = phys.nondim_scaling
    qf, nvec = faces["qf"], faces["n"]
    mu_s = scaling * faces["muf"]
    mut_s = scaling * faces["mut"]
    kt = faces["kt"]
    tgn = (faces["grads"]["temp"] * nvec).sum(dim=0)
    out = {}
    for spec in block.surfaces:
        if spec.bc_type != "viscousWall" or spec.direction != d:
            continue
        sl = [None, None, None]
        sl[AX[d]] = 0 if spec.lower else dims[d]
        taxes = [a for a in range(3) if a != AX[d]]
        for a, (lo, hi) in zip(taxes, spec.patch):
            sl[a] = slice(lo - g, hi - g)
        sl = tuple(sl)
        esl = (slice(None),) + sl
        qw_f = qf[esl]
        rho_f = st.rho(phys, qw_f)
        t_f = st.temperature(phys, qw_f)
        tau_f = faces["tau"][esl]
        ustar = torch.sqrt(torch.sqrt((tau_f * tau_f).sum(dim=0)) / rho_f)
        mu_f, mut_f = mu_s[sl], mut_s[sl]
        kt_f = kt[sl] if torch.is_tensor(kt) else 0.0
        qflux = (faces["k_eff"][sl] + kt_f) * tgn[sl]
        # wall distance of the boundary-adjacent cell
        asl = [None, None, None]
        asl[AX[d]] = g if spec.lower else g + dims[d] - 1
        for a, (lo, hi) in zip(taxes, spec.patch):
            asl[a] = slice(lo, hi)
        ydist = block.geom["wall_dist"][tuple(asl)]
        entry = dict(tau=tau_f, q=qflux, rho=rho_f, t=t_f, mu=mu_f,
                     mut=mut_f, u_star=ustar,
                     yplus=ydist * ustar * rho_f / (mu_f + mut_f),
                     tke=qw_f[phys.it] if is_rans else None,
                     sdr=qw_f[phys.it + 1] if is_rans else None)
        if (wall_data and id(spec) in wall_data
                and spec.data is not None and spec.data.wall_law):
            wv = wall_data[id(spec)]
            lr = wv["low_re"]
            sgn = 1.0 if spec.lower else -1.0
            for key in ("tau", "q", "rho", "t", "mu", "mut", "u_star",
                        "yplus", "tke", "sdr"):
                if entry[key] is None:
                    continue
                if key == "tau":
                    entry[key] = torch.where(lr[None], entry[key],
                                             sgn * wv[key])
                else:
                    entry[key] = torch.where(lr, entry[key], wv[key])
        out[id(spec)] = entry
    return out


def viscous_residual(phys: Physics, cfg, block, prim, t_all, mu_all,
                     wall_data=None, need_pgrad=False, need_aux=False):
    """Viscous flux residual contribution + gradients + eddy viscosity +
    viscous spectral radii (reference: procBlock.cpp:1233-1879).

    Returns (resid_v, sr_flow, sr_turb, diag_flow, diag_turb, cellavg)
    where resid_v is ADDED to the inviscid residual (sign handled here);
    with more than one species and ``cfg['diffusion']`` schmidt its
    species rows hold the diffusion fluxes (zeroed on viscousWall faces),
    and cellavg holds the 1/6-weighted cell gradients ('vel' and, with
    turbulence equations, 'tke' and 'omega') and mut / f1 / f2 (zeros for
    a laminar deck; WALE and Wilcox have f1 = 1, f2 = 0).  With ``cfg['block_matrix']`` (blusgs) it
    also returns the thin-shear-layer block diagonal, diag_flow_blk
    (ni, nj, nk, N, N) and diag_turb_blk (ni, nj, nk, 2, 2)
    (procBlock.cpp:1414-1470).  ``wall_data`` holds the wall-law values
    of the viscous ghost pass (``face_terms``); ``need_pgrad`` (a deck
    with LODI surfaces) adds the cell-average pressure gradient
    'press'.  ``need_aux`` (file output) adds the cell-average 'temp',
    'rho' and 'press' gradients, with more than one species 'mix' (a
    list of ns (3, ni, nj, nk)), and 'wall_out': per viscousWall surface
    (by ``id(spec)``) its faces' records (``_wall_records``)."""
    g = block.g
    dims = dict(i=block.ni, j=block.nj, k=block.nk)
    model = cfg["turb_model"]
    is_rans = phys.nturb > 0
    is_turb = cfg.get("turbulent", is_rans)
    blk = bool(cfg.get("block_matrix"))
    visc_coeff = cfg["viscous_cfl_coeff"]
    scaling = phys.nondim_scaling
    prt = turb_prandtl(model)
    statics = viscous_statics(block, needs_face_length(cfg))

    shape_c = (block.ni, block.nj, block.nk)
    kw = dict(dtype=prim.dtype, device=prim.device)
    resid = torch.zeros((phys.neq,) + shape_c, **kw)
    sr_flow = torch.zeros(shape_c, **kw)
    sr_turb = torch.zeros(shape_c, **kw)
    diag_flow = torch.zeros(shape_c, **kw)
    diag_turb = torch.zeros(shape_c, **kw)
    ca_keys = (["vel"] + (["temp", "rho"] if need_aux else [])
               + (["press"] if need_aux or need_pgrad else [])
               + (["tke", "omega"] if is_rans else []))
    cellavg = dict(mut=torch.zeros(shape_c, **kw),
                   f1=torch.zeros(shape_c, **kw),
                   f2=torch.zeros(shape_c, **kw))
    for key in ca_keys:
        lead = (3, 3) if key == "vel" else (3,)
        cellavg[key] = torch.zeros(lead + shape_c, **kw)
    multi_aux = phys.ns > 1 and need_aux
    if multi_aux:
        cellavg["mix"] = [torch.zeros((3,) + shape_c, **kw)
                          for _ in range(phys.ns)]
    wall_out = {}
    if blk:
        from . import block_jac as bj     # block_jac imports this module
        N = phys.ns + 4
        diag_flow_blk = torch.zeros(shape_c + (N, N), **kw)
        diag_turb_blk = (torch.zeros(shape_c + (2, 2), **kw) if is_rans
                         else None)

    P = tuple(slice(g, g + dims[dd]) for dd in "ijk")
    cell_q = prim[(slice(None),) + P]
    cell_mu = mu_all[P]
    r_c = st.rho(phys, cell_q)
    gam = phys.gamma(t_all[P], st.mixture_fractions(phys, cell_q))
    max_term = torch.maximum(4.0 / (3.0 * r_c), gam / r_c)
    prand = 4.0 * gam / (9.0 * gam - 5.0)
    vol_c = statics["cell"][0]

    for a, d in enumerate("ijk"):
        ax = 1 + AX[d]
        n = dims[d]
        faces = face_terms(phys, cfg, block, prim, t_all, mu_all, d,
                           wall_data, need_pgrad, need_aux)
        if need_aux:
            wall_out.update(_wall_records(phys, block, d, faces,
                                          wall_data))
        grads, fa = faces["grads"], faces["fa"]
        mutf, f1f, f2f = faces["mut"], faces["f1"], faces["f2"]
        lo = [slice(None)] * 4
        hi = [slice(None)] * 4
        lo[ax] = slice(0, n)
        hi[ax] = slice(1, n + 1)
        # viscous fluxes subtract where inviscid adds (procBlock.cpp:1395)
        resid = resid - (fa[tuple(hi)] - fa[tuple(lo)])

        flo3, fhi3 = _face_lohi(AX[d], n)
        if blk:
            # TSL viscous block diagonal (procBlock.cpp:1414-1470): a cell
            # gets +TSL(right) at its lower face, -TSL(left) at its upper
            # face; the face distance is the centre-to-centre distance
            # projected on the face normal
            center = block.geom["center"]
            c2c = (_cellslab(block, d, center, 1)
                   - _cellslab(block, d, center, 0))
            nvec = faces["n"]
            dist_f = torch.abs((c2c * nvec).sum(dim=0))
            tsl = (phys, cfg, faces["qf"], faces["muf"], mutf, f1f, nvec,
                   faces["mag"], dist_f, grads["vel"])
            jl_f, jl_t = bj.approx_tsl_jacobian(*tsl, left=True)
            jr_f, jr_t = bj.approx_tsl_jacobian(*tsl, left=False)
            diag_flow_blk = diag_flow_blk + jr_f[flo3] - jl_f[fhi3]
            if is_rans:
                diag_turb_blk = diag_turb_blk + jr_t[flo3] - jl_t[fhi3]

        # cell-average gradient/mut accumulation (1/6 per face)
        sixth = 1.0 / 6.0
        for key in ca_keys:
            garr = grads[key]
            cellavg[key] = cellavg[key] + sixth * (
                garr[(Ellipsis,) + flo3] + garr[(Ellipsis,) + fhi3])
        if multi_aux:
            for ss in range(phys.ns):
                garr = grads["mix"][ss]
                cellavg["mix"][ss] = cellavg["mix"][ss] + sixth * (
                    garr[(Ellipsis,) + flo3] + garr[(Ellipsis,) + fhi3])
        for key, farr in (("mut", mutf), ("f1", f1f), ("f2", f2f)):
            cellavg[key] = cellavg[key] + sixth * (farr[flo3] + farr[fhi3])

        # viscous spectral radius (cell): uses mut at the cell's lower face
        mut_lo_face = mutf[flo3]
        f1_lo_face = f1f[flo3]
        fmag = statics["cell"][1 + a]
        visc_term = scaling * (cell_mu / prand
                               + (mut_lo_face / prt if is_turb else 0.0))
        vsr = max_term * visc_term * fmag * fmag / vol_c
        sr_flow = sr_flow + visc_coeff * vsr
        diag_flow = diag_flow + 2.0 * vsr
        if is_rans:
            if model == "kOmegaWilcox2006":
                mut_nolim = r_c * cell_q[phys.it] / cell_q[phys.it + 1]
                tvsr = scaling * (fmag * fmag / vol_c) / r_c * (
                    cell_mu + sigma_k(model, 1.0) * mut_nolim)
            else:
                tvsr = scaling * (fmag * fmag / vol_c) / r_c * (
                    cell_mu + sigma_k(model, f1_lo_face) * mut_lo_face)
            sr_turb = sr_turb + visc_coeff * tvsr
            diag_turb = diag_turb + 2.0 * tvsr

    if need_aux:
        cellavg["wall_out"] = wall_out
    if blk:
        return (resid, sr_flow, sr_turb, diag_flow, diag_turb, cellavg,
                diag_flow_blk, diag_turb_blk)
    return resid, sr_flow, sr_turb, diag_flow, diag_turb, cellavg
