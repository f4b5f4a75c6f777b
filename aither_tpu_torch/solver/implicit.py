"""Implicit operator pieces for scalar and block LU-SGS (lusgs, blusgs)
and DPLUR (dplur, bdplur): off-diagonals (Rusanov and approximateRoe),
diagonal, right-hand side (one or two time levels), the DPLUR relaxation,
matrix residual, and the hyperplane plan the sweeps walk.

Port of ``aither_tpu/solver/implicit.py`` (``:42-110`` spectral radii and
the Rusanov off-diagonal, ``:113-150`` the Roe off-diagonal, ``:153-205``
the block off-diagonal and its dispatch, ``:254-309`` neighbour masks,
``:441-481`` off-diagonal sums, ``:488-586`` time terms, rhs, scalar and
block diagonals, ``:610-618`` DPLUR, ``:1130`` matrix residual with the
multigrid forcing;
reference: src/linearSolver.cpp:45-535, src/fluxJacobian.cpp
RusanovScalarOffDiagonal / RusanovBlockOffDiagonal / RoeOffDiagonal).

The JAX package walks the LU-SGS hyperplanes i+j+k=p in a skewed layout
built for the TPU.  Here the sweep works in the physical padded layout:
``SweepPlan`` lists each hyperplane's physical cells once on the host
(plane-ordered flat indices, ``plane_ptr`` offsets) together with the
per-cell face geometry and masks of both sweep sides.  The CUDA kernels
walk the same planes as a wavefront of tiles (``sweep_tile``,
``tile_table``).  The sweeps themselves (plain PyTorch and the CUDA
kernels) live in ``aither_tpu_torch/kernels/lusgs_sweep.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..grid.geometry import AX
from ..physics.models import Physics, prandtl
from . import block_jac as bj
from . import state as st
from .flux import physical_flux, roe_flux
from .viscous import sigma_k


# ---------------------------------------------------------------------------
# scalar approximate off-diagonal (Rusanov):
#   0.5*|A|*(F(q+du) - F(q)).n  [turb zeroed]  +- specRad_face * du


def viscous_face_spectral_radius(phys: Physics, q, mag, dist, mu, mut=None):
    """|A|/d . max(4/3rho, gamma/rho) . (mu/Pr + mut/Prt)
    (reference: spectralRadius.hpp:126-151 ViscFaceSpectralRadius)."""
    t = st.temperature(phys, q)
    r = st.rho(phys, q)
    mf = st.mixture_fractions(phys, q)
    max_term = torch.maximum(4.0 / (3.0 * r), phys.gamma(t, mf) / r)
    visc_term = phys.nondim_scaling * (
        mu / prandtl(phys, t, mf)
        + (mut / phys.turb_prandtl() if mut is not None else 0.0))
    return mag / dist * max_term * visc_term


def face_spectral_radius(phys: Physics, q, n, mag, dist=None, mu=None,
                         mut=None, viscous=False):
    """0.5*|A|*(|v.n| + a) (+ viscous term)
    (reference: spectralRadius.hpp:66-80, 126-151)."""
    vel = st.velocity(phys, q)
    sr = 0.5 * mag * (torch.abs((vel * n).sum(dim=0)) + st.sos(phys, q))
    if viscous:
        sr = sr + viscous_face_spectral_radius(phys, q, mag, dist, mu, mut)
    return sr


def _turb_viscous_face_sr(phys: Physics, cfg, q_nb, mag, dist, mu, mut, f1):
    """Turbulence-equation viscous face spectral radius
    |A|/d.(mu + sigma_k.mut)/rho; Wilcox takes the unlimited rho k / omega
    of the neighbour state, not the mut field
    (reference: turbulence.cpp ViscFaceSpecRad per model)."""
    r = st.rho(phys, q_nb)
    model = cfg["turb_model"]
    if model == "kOmegaWilcox2006":
        mutx = r * q_nb[phys.it] / q_nb[phys.it + 1]
        sk = sigma_k(model, 1.0)
    else:
        mutx = mut
        sk = sigma_k(model, f1)
    return phys.nondim_scaling * (mag / dist) / r * (mu + sk * mutx)


def offdiagonal_scalar(phys: Physics, cfg, q_nb, du_nb, n, mag, positive,
                       dist=None, mu=None, mut=None, f1=None):
    """Scalar Rusanov off-diagonal contribution of one neighbour."""
    q_up = st.update_prim_with_cons(phys, q_nb, du_nb)
    dflux = 0.5 * mag[None] * (physical_flux(phys, q_up, n)
                               - physical_flux(phys, q_nb, n))
    viscous = cfg.get("viscous", False)
    sr = face_spectral_radius(phys, q_nb, n, mag, dist, mu, mut, viscous)
    term = sr[None] * du_nb
    if phys.nturb:
        dflux = torch.cat([dflux[:phys.it],
                           torch.zeros_like(dflux[phys.it:])])
        # turbulence inviscid face spectral radius (turbulence.cpp:112-120)
        vn = (st.velocity(phys, q_nb) * n).sum(dim=0)
        sr_t = (0.5 * mag * torch.abs(vn + torch.abs(vn)) if positive
                else 0.5 * mag * torch.abs(vn - torch.abs(vn)))
        if viscous and mut is not None:
            sr_t = sr_t + _turb_viscous_face_sr(phys, cfg, q_nb, mag, dist,
                                                mu, mut, f1)
        term = torch.cat([term[:phys.it], sr_t[None] * du_nb[phys.it:]])
    return dflux + term if positive else dflux - term


def roe_offdiagonal(phys: Physics, cfg, q_nb, q_diag, du_nb, n, mag,
                    positive, dist=None, mu=None, mut=None, f1=None):
    """approximateRoe off-diagonal: the change of the Roe face flux caused
    by the neighbour's update, the diagonal cell's state held fixed, plus
    or minus the viscous-only face radii times du (reference:
    fluxJacobian.cpp:240-330 RoeOffDiagonal).

    As in the JAX package's ``roe_offdiagonal``: the old flux always has
    the neighbour on the left while the new flux swaps sides for the upper
    (positive=False) sweep, so the upper form is not zero at du = 0 but the
    side-swap offset mag (F(diag, nb) - F(nb, diag)); and the viscous
    radius takes (mu, mut, dist, f1) in their right order (the reference's
    call site swaps dist and f1, which no viscous deck survives)."""
    old = roe_flux(phys, q_nb, q_diag, n)
    q_up = st.update_prim_with_cons(phys, q_nb, du_nb)
    new = (roe_flux(phys, q_up, q_diag, n) if positive
           else roe_flux(phys, q_diag, q_up, n))
    dflux = mag[None] * (new - old)
    if not cfg.get("viscous", False):
        return dflux
    # viscous-only face radius (no inviscid part, unlike Rusanov's)
    term = viscous_face_spectral_radius(phys, q_nb, mag, dist, mu,
                                        mut)[None] * du_nb
    if phys.nturb:
        sr_t = _turb_viscous_face_sr(phys, cfg, q_nb, mag, dist, mu, mut, f1)
        term = torch.cat([term[:phys.it], sr_t[None] * du_nb[phys.it:]])
    return dflux + term if positive else dflux - term


def offdiagonal(phys: Physics, cfg, q_nb, du_nb, n, mag, positive,
                q_diag=None, **kw):
    """Off-diagonal dispatch on inviscidFluxJacobian, then the matrix
    solver: the Roe flux change for approximateRoe with the scalar and the
    block solvers alike (it reads the diagonal cell's state ``q_diag``);
    else the block Rusanov form for blusgs / bdplur, the scalar one
    otherwise (reference: fluxJacobian.cpp:196-237 OffDiagonal)."""
    if cfg.get("inv_flux_jac", "rusanov") == "approximateRoe":
        kw.pop("vgrad", None)
        return roe_offdiagonal(phys, cfg, q_nb, q_diag, du_nb, n, mag,
                               positive, **kw)
    if cfg.get("block_matrix"):
        return offdiagonal_block_channels(phys, cfg, q_nb, du_nb, n, mag,
                                          positive, **kw)
    kw.pop("vgrad", None)
    return offdiagonal_scalar(phys, cfg, q_nb, du_nb, n, mag, positive, **kw)


def offdiagonal_block_channels(phys: Physics, cfg, q_nb, du_nb, n, mag,
                               positive, dist=None, mu=None, mut=None,
                               f1=None, vgrad=None):
    """Block Rusanov off-diagonal (J_rusanov(+-) -+ J_TSL).du as row
    matvecs with no trailing matrix axes: no Jacobian is assembled, the
    form the sweep kernel (csrc/blusgs_sweep.cu) evaluates per cell
    (reference: fluxJacobian.cpp RusanovBlockOffDiagonal)."""
    y = bj.rusanov_offdiag_matvec(phys, q_nb, n, mag, positive, du_nb)
    if cfg.get("viscous"):
        vf, vt = bj.tsl_offdiag_matvec(phys, cfg, q_nb, mu, mut, f1, n,
                                       mag, dist, vgrad, left=positive,
                                       du=du_nb)
        s = -1.0 if positive else 1.0
        parts = [y[:phys.ns + 4] + s * vf]
        if phys.nturb:
            parts.append(y[phys.it:] + s * vt)
        y = torch.cat(parts, dim=0)
    return y


# ---------------------------------------------------------------------------
# neighbour masks and vectorized off-diagonal sums


def _connection_face_mask(block, d: str, lower: bool):
    """cells whose face on (d, side) is a connection (ni,nj,nk boolean on
    the boundary layer, False elsewhere)."""
    dims = {"i": block.ni, "j": block.nj, "k": block.nk}
    mask = np.zeros((block.ni, block.nj, block.nk), dtype=bool)
    for spec in block.surfaces:
        if spec.bc_type not in ("interblock", "periodic"):
            continue
        if spec.direction != d or spec.lower != lower:
            continue
        sl = [None, None, None]
        sl[AX[d]] = 0 if lower else dims[d] - 1
        taxes = [a for a in range(3) if a != AX[d]]
        for a, (lo, hi) in zip(taxes, spec.patch):
            sl[a] = slice(lo - block.g, hi - block.g)
        mask[tuple(sl)] = True
    return mask


def neighbor_masks(block, side: str):
    """{d: (ni, nj, nk) bool}: True where the cell's neighbour across its
    lower (upper) face contributes — an interior neighbour or a
    connection ghost (the JAX package's mask_lower / mask_upper)."""
    ii, jj, kk = np.meshgrid(np.arange(block.ni), np.arange(block.nj),
                             np.arange(block.nk), indexing="ij")
    out = {}
    for d in "ijk":
        idx = [ii, jj, kk][AX[d]]
        n = [block.ni, block.nj, block.nk][AX[d]]
        conn = _connection_face_mask(block, d, side == "lower")
        out[d] = ((idx > 0) if side == "lower" else (idx < n - 1)) | conn
    return out


def _neighbor_slices(block, d: str, side: str):
    """padded slices: (neighbour cells, shared faces) for each physical cell
    along direction d."""
    g = block.g
    dims = {"i": block.ni, "j": block.nj, "k": block.nk}
    cell = [slice(g, g + dims[dd]) for dd in "ijk"]
    nb = list(cell)
    face = list(cell)
    ax = AX[d]
    n = dims[d]
    if side == "lower":
        nb[ax] = slice(g - 1, g + n - 1)
        face[ax] = slice(g, g + n)
    else:
        nb[ax] = slice(g + 1, g + n + 1)
        face[ax] = slice(g + 1, g + n + 1)
    return tuple(nb), tuple(face)


def offdiag_sum(phys: Physics, cfg, block, prim, du, side: str, aux=None):
    """Sum of lower (or upper) off-diagonal contributions for every physical
    cell, in one vectorized pass
    (reference: procBlock::ImplicitLower/Upper)."""
    key = ("nbr_mask", side)
    if key not in block.cache:
        block.cache[key] = {d: torch.as_tensor(m, device=prim.device)
                            for d, m in neighbor_masks(block, side).items()}
    masks = block.cache[key]
    positive = side == "lower"
    q_diag = prim[block.interior]
    total = 0.0
    for d in "ijk":
        nb, face = _neighbor_slices(block, d, side)
        kw = {}
        if cfg.get("viscous", False):
            kw = _viscous_offdiag_kw(block, d, nb, face, aux)
        contrib = offdiagonal(
            phys, cfg, prim[(slice(None),) + nb], du[(slice(None),) + nb],
            block.geom[f"n_{d}"][(slice(None),) + face],
            block.geom[f"mag_{d}"][face], positive, q_diag=q_diag, **kw)
        total = total + torch.where(masks[d][None], contrib, 0.0)
    return total


def _viscous_offdiag_kw(block, d, nb, face, aux):
    g = block.g
    dims = {"i": block.ni, "j": block.nj, "k": block.nk}
    cell = tuple(slice(g, g + dims[dd]) for dd in "ijk")
    center = block.geom["center"]
    c2c = center[(slice(None),) + cell] - center[(slice(None),) + nb]
    nvec = block.geom[f"n_{d}"][(slice(None),) + face]
    dist = torch.abs((c2c * nvec).sum(dim=0))
    out = dict(dist=dist, mu=aux["mu"][nb], mut=aux["mut"][nb],
               f1=aux["f1"][nb])
    if "vgrad" in aux:
        out["vgrad"] = aux["vgrad"][(slice(None), slice(None)) + nb]
    return out


# ---------------------------------------------------------------------------
# time terms, diagonal and rhs (reference: procBlock.cpp:1000-1034,
# linearSolver.cpp:56-160)


def sol_delta_coeffs(block, dt, theta, zeta):
    """(1+zeta)V/(dt theta) and zeta V/(dt theta), the weights of the time
    n and n-1 solution changes (reference: procBlock.cpp:1000-1034)."""
    g = block.g
    P = tuple(slice(g, g + n) for n in (block.ni, block.nj, block.nk))
    vol = block.geom["vol"][P]
    return vol * (1.0 + zeta) / (dt * theta), vol * zeta / (dt * theta)


def rhs_b(phys: Physics, block, cfg, prim, resid, cons_n, dt,
          cons_nm1=None):
    """b = -1/theta.R [+ zeta V/(dt theta)(consN - consNm1)]
    - (1+zeta)V/(dt theta)(cons - consN), the bracket when the time
    integrator is multilevel (bdf2: ``cfg['multilevel_time']``,
    ``cons_nm1`` the time n-1 interiors) (reference: linearSolver.cpp:56-76;
    the multigrid forcing is added where the driver relaxes,
    ``Solver._relax``)."""
    theta, zeta = cfg["theta"], cfg["zeta"]
    coeff_n, coeff_nm1 = sol_delta_coeffs(block, dt, theta, zeta)
    b = -(1.0 / theta) * resid
    if cfg.get("multilevel_time"):
        b = b + coeff_nm1[None] * (cons_n - cons_nm1)
    cons_m = st.cons_from_prim(phys, prim[block.interior])
    return b - coeff_n[None] * (cons_m - cons_n)


def build_diagonal(phys: Physics, block, cfg, diag_flow, diag_turb, sr_max,
                   dt):
    """A = a*relax + (1+zeta)V/(dt theta) [+ max(specrad)/dualCFL]; returns
    (inv_flow, inv_turb) (reference: linearSolver.cpp:127-160)."""
    g = block.g
    P = tuple(slice(g, g + n) for n in (block.ni, block.nj, block.nk))
    vol = block.geom["vol"][P]
    theta, zeta = cfg["theta"], cfg["zeta"]
    diag_vol_time = vol * (1.0 + zeta) / (dt * theta)
    if cfg["dual_time_cfl"] > 0.0:
        diag_vol_time = diag_vol_time + sr_max / cfg["dual_time_cfl"]
    relax = cfg["matrix_relaxation"]
    inv_flow = 1.0 / (diag_flow * relax + diag_vol_time)
    inv_turb = None
    if phys.nturb:
        inv_turb = 1.0 / (diag_turb * relax + diag_vol_time)
    return inv_flow, inv_turb


def diag_mult(phys: Physics, inv_flow, inv_turb, x):
    """apply the (inverted) scalar diagonal; the block diagonal is applied
    as channels by ``diag_mult_channels``."""
    out = x * inv_flow[None]
    if phys.nturb and inv_turb is not None:
        out = torch.cat([out[:phys.it], x[phys.it:] * inv_turb[None]])
    return out


def diag_mult_channels(phys: Physics, inv_flow_ch, inv_turb_ch, x):
    """The block diag_mult with the inverted blocks as channels:
    inv_flow_ch (N*N, ...) row-major, inv_turb_ch (4, ...) — the layout
    the sweep kernel reads (``blk_to_channels``)."""
    N = phys.ns + 4
    yf = [sum(inv_flow_ch[i * N + j] * x[j] for j in range(N))
          for i in range(N)]
    out = torch.stack(yf)
    if phys.nturb and inv_turb_ch is not None:
        it = phys.it
        yt = torch.stack(
            [inv_turb_ch[0] * x[it] + inv_turb_ch[1] * x[it + 1],
             inv_turb_ch[2] * x[it] + inv_turb_ch[3] * x[it + 1]])
        out = torch.cat([out, yt], dim=0)
    return out


def blk_to_channels(mat):
    """(ni, nj, nk, N, M) block matrices -> contiguous (N*M, ni, nj, nk)
    row-major channels (the JAX package's _blk_to_channels, physical
    layout)."""
    *cells, n, m = mat.shape
    return torch.movedim(mat.reshape(*cells, n * m), -1, 0).contiguous()


def build_block_diagonal(phys: Physics, block, cfg, diag_flow_blk,
                         diag_turb_blk, sr_max, dt):
    """Block A = relax*accumulated + ((1+zeta)V/(dt theta) [+ sr/dualCFL]).I
    and its batched inverse; returns ((a_flow, a_turb), (inv_flow,
    inv_turb)) (reference: linearSolver.cpp:127-177)."""
    g = block.g
    P = tuple(slice(g, g + n) for n in (block.ni, block.nj, block.nk))
    vol = block.geom["vol"][P]
    theta, zeta = cfg["theta"], cfg["zeta"]
    dvt = vol * (1.0 + zeta) / (dt * theta)
    if cfg["dual_time_cfl"] > 0.0:
        dvt = dvt + sr_max / cfg["dual_time_cfl"]
    relax = cfg["matrix_relaxation"]
    kw = dict(dtype=diag_flow_blk.dtype, device=diag_flow_blk.device)
    a_flow = diag_flow_blk * relax + dvt[..., None, None] * torch.eye(
        phys.ns + 4, **kw)
    a_turb = None
    if phys.nturb and diag_turb_blk is not None:
        a_turb = diag_turb_blk * relax + dvt[..., None, None] * torch.eye(
            2, **kw)
    return (a_flow, a_turb), bj.block_inverse(a_flow, a_turb)


def dplur_sweep(phys: Physics, cfg, block, prim, du_padded, b, inv_flow,
                inv_turb, aux=None):
    """One DPLUR (Jacobi) relaxation of one block: both off-diagonal sums
    at the sweep-start du, then du = D^-1 (b + L - U) on the interior, in
    place; the scalar inverse, or for bdplur the block inverse as channels
    (reference: linearSolver.cpp:472-535)."""
    L = offdiag_sum(phys, cfg, block, prim, du_padded, "lower", aux)
    U = offdiag_sum(phys, cfg, block, prim, du_padded, "upper", aux)
    dmul = diag_mult_channels if cfg.get("block_matrix") else diag_mult
    du_padded[block.interior] = dmul(phys, inv_flow, inv_turb, b + L - U)
    return du_padded


def matrix_residual(phys: Physics, cfg, block, prim, du_padded, b, a_flow,
                    a_turb, aux=None, forcing=None):
    """forcing - (A.x - b) per cell, A's diagonal scalar or block, the
    multigrid forcing zero unless given (reference:
    linearSolver.cpp:45-100)."""
    x = du_padded[block.interior]
    L = offdiag_sum(phys, cfg, block, prim, du_padded, "lower", aux)
    U = offdiag_sum(phys, cfg, block, prim, du_padded, "upper", aux)
    if a_flow.dim() == x.dim() + 1:
        ax = bj.block_matvec(a_flow, a_turb, x, phys)
    else:
        ax = x * a_flow[None]
        if phys.nturb and a_turb is not None:
            ax = torch.cat([ax[:phys.it], x[phys.it:] * a_turb[None]])
    axmb = ax - (L - U) - b
    return forcing - axmb if forcing is not None else -axmb


# ---------------------------------------------------------------------------
# hyperplane plan for the LU-SGS sweeps

# per-cell static channels of one sweep side, per direction
STATIC_CHANNELS = ("nx", "ny", "nz", "mag", "dist")


@dataclasses.dataclass
class SweepPlan:
    """One block's hyperplanes p = i+j+k in physical layout.

    ``cells`` holds every physical cell's flat index into the padded
    (NI, NJ, NK) block, ordered by hyperplane (then i, then j);
    plane p owns ``cells[plane_ptr[p]:plane_ptr[p+1]]``.  ``phys_cells``
    are the same cells' flat indices into the unpadded (ni, nj, nk) block.
    ``static[side]`` is (ncell, 3, 5) float in physical cell order (index
    it by ``phys_cells``): per direction the unit normal and area of the
    face shared with the lower (upper) neighbour and the face-projected
    cell-centre distance to it; ``mask[side]`` is (ncell, 3) bool, also in
    physical order: the neighbour contributes (an interior cell or a
    connection ghost).  The CUDA kernels read both as they are (a bool is
    one byte, 0 or 1), with the block's ``tile`` (``sweep_tile``), its
    ``tiles`` table (``tile_table``) and ``tile_state``, the schedule's
    ticket and progress flags (1 + ntiles int32, zeroed before each
    launch)."""

    dims: tuple               # (ni, nj, nk)
    g: int
    padded: tuple             # (NI, NJ, NK)
    plane_ptr: np.ndarray     # (nplanes + 1,) int32, host
    cells: torch.Tensor       # (ncell,) int64
    phys_cells: torch.Tensor  # (ncell,) int64
    static: dict              # side -> (ncell, 3, 5), physical order
    mask: dict                # side -> (ncell, 3) bool, physical order
    tile: tuple               # (ti, tj, tk)
    tiles: torch.Tensor       # (ntiles, 6) int32
    tile_state: torch.Tensor  # (1 + ntiles,) int32

    @property
    def nplanes(self) -> int:
        return len(self.plane_ptr) - 1

    @property
    def strides(self) -> tuple:
        """flat-index step of one cell in i, j and k (padded layout)"""
        _, NJ, NK = self.padded
        return (NJ * NK, NK, 1)


def build_sweep_plan(block, dtype, device) -> SweepPlan:
    """Hyperplane cell lists and per-side static face geometry for one
    block, built once on the host from ``block.geom_host`` (the values of
    the JAX package's ``_static_neighbor_geom``)."""
    ni, nj, nk, g = block.ni, block.nj, block.nk, block.g
    NI, NJ, NK = block.shape
    ii, jj, kk = np.meshgrid(np.arange(ni), np.arange(nj), np.arange(nk),
                             indexing="ij")
    ii, jj, kk = ii.ravel(), jj.ravel(), kk.ravel()
    p = ii + jj + kk
    order = np.lexsort((jj, ii, p))          # by plane, then i, then j
    ii, jj, kk, p = ii[order], jj[order], kk[order], p[order]
    nplanes = ni + nj + nk - 2
    plane_ptr = np.zeros(nplanes + 1, dtype=np.int32)
    plane_ptr[1:] = np.cumsum(np.bincount(p, minlength=nplanes))
    pi, pj, pk = ii + g, jj + g, kk + g
    cells = (pi * NJ + pj) * NK + pk
    phys_cells = (ii * nj + jj) * nk + kk

    # the statics and masks in physical order: slices of the padded
    # geometry, raveled as the (ni, nj, nk) block is
    center = block.geom_host["center"]
    cell = (slice(None),) + tuple(slice(g, g + n) for n in (ni, nj, nk))
    static, mask = {}, {}
    for side in ("lower", "upper"):
        masks = neighbor_masks(block, side)
        stat = np.zeros((len(cells), 3, len(STATIC_CHANNELS)))
        msk = np.zeros((len(cells), 3), dtype=bool)
        for a, d in enumerate("ijk"):
            nb, face = _neighbor_slices(block, d, side)
            nvec = block.geom_host[f"n_{d}"][(slice(None),) + face].reshape(
                3, -1)
            c2c = (center[cell] - center[(slice(None),) + nb]).reshape(3, -1)
            stat[:, a, 0:3] = nvec.T
            stat[:, a, 3] = block.geom_host[f"mag_{d}"][face].reshape(-1)
            stat[:, a, 4] = np.abs((c2c * nvec).sum(axis=0))
            msk[:, a] = masks[d].reshape(-1)
        static[side] = torch.as_tensor(stat, dtype=dtype, device=device)
        mask[side] = torch.as_tensor(msk, device=device)
    tile = sweep_tile((ni, nj, nk))
    tiles = tile_table((ni, nj, nk), tile)
    return SweepPlan(
        dims=(ni, nj, nk), g=g, padded=(NI, NJ, NK), plane_ptr=plane_ptr,
        cells=torch.as_tensor(cells, dtype=torch.int64, device=device),
        phys_cells=torch.as_tensor(phys_cells, dtype=torch.int64,
                                   device=device),
        static=static, mask=mask, tile=tile,
        tiles=torch.as_tensor(tiles, device=device),
        tile_state=torch.zeros(1 + len(tiles), dtype=torch.int32,
                               device=device))


# ---------------------------------------------------------------------------
# tiles of the CUDA sweeps' wavefront (csrc/sweep_wavefront.cuh)

# (j, k) columns of one tile: three CUDA lanes each, one per direction
# (wavefront::MAX_TILE_COLUMNS)
MAX_TILE_COLUMNS = 80


def sweep_tile(dims) -> tuple:
    """the tile (ti, tj, tk) of the CUDA sweeps for a block of ``dims``:
    columns of 32 cells in i, 4 x 5 of them in (j, k), or 40 x 1 where
    the block is one cell thick in k (among the fastest of the shapes
    tried on an H100: PERF.md, section 6)"""
    return (32, 40, 1) if dims[2] == 1 else (32, 4, 5)


@functools.lru_cache(maxsize=None)
def wavefront_ctas(dims, tile) -> int:
    """persistent CTAs of a sweep's wavefront, every form of both sweep
    kernels (``csrc/sweep_wavefront.cuh`` launch_lanes): 1.25 x the most
    tiles
    that share a hyperplane of the forward sweep (a tile spans the planes from
    its origin's i + j + k through its last cell's), at most the tiles.
    The tiles a sweep works on at once keep a CTA each, and the blocks of
    a sweep, each launched with so many, run side by side."""
    table = tile_table(dims, tile)
    first = table[:, :3].sum(axis=1)
    last = first + table[:, 3:].sum(axis=1) - 3
    span = np.zeros(int(last.max()) + 2, dtype=np.int64)
    np.add.at(span, first, 1)
    np.add.at(span, last + 1, -1)
    return int(min(len(table), -(-5 * int(np.cumsum(span).max()) // 4)))


def tile_table(dims, tile) -> np.ndarray:
    """(ntiles, 6) int32: origin (i, j, k) and extent of every tile of a
    block of ``dims`` cut into boxes of ``tile`` cells (ragged at the upper
    ends), in a topological order of the forward sweep: by the hyperplane
    i + j + k of the origin, then i, then j.  A tile's lower neighbour
    tiles have smaller origin sums, so they come first; the backward sweep
    walks the table from its end."""
    tile = tuple(int(t) for t in tile)
    if any(t < 1 for t in tile) or tile[1] * tile[2] > MAX_TILE_COLUMNS:
        raise ValueError(f"tile {tile}: each extent >= 1 and at most "
                         f"{MAX_TILE_COLUMNS} (j, k) columns")
    axes = [np.arange(0, n, t) for n, t in zip(dims, tile)]
    oi, oj, ok = (a.ravel() for a in np.meshgrid(*axes, indexing="ij"))
    order = np.lexsort((ok, oj, oi, oi + oj + ok))
    origin = np.stack([oi, oj, ok], axis=1)[order]
    extent = np.minimum(np.asarray(tile), np.asarray(dims) - origin)
    return np.ascontiguousarray(np.concatenate([origin, extent], axis=1),
                                dtype=np.int32)
