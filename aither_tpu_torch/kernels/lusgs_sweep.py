"""LU-SGS hyperplane sweeps: the hand-written CUDA kernels and their plain
PyTorch version.

``forward`` / ``backward`` sweep one block in place.  On a CPU tensor they
run the plain PyTorch version (``forward_plain`` / ``backward_plain``); on
a CUDA tensor they launch a kernel (built at first use) and raise if it
cannot run — there is no fallback: ``csrc/lusgs_sweep.cu`` for the scalar
solver (lusgs), ``csrc/blusgs_sweep.cu`` for the block solver (blusgs,
``cfg['block_matrix']``).  Both walk the block's hyperplanes in one launch
as a wavefront of tiles (``csrc/sweep_wavefront.cuh``;
``implicit.sweep_tile``).
``LAUNCHES`` / ``BLOCK_LAUNCHES`` count each kernel's launches (one per
block and sweep), ``STATE_RESETS`` the cudaMemsetAsync of the schedule's
ticket and flags before each of them.

Replaces the TPU kernel ``aither_tpu/solver/pallas_sweep.py::sweep``,
variants (a) (scalar LU-SGS, no lagged term), (b) (``with_extra``: the
lagged opposite-side term of ``matrixSweeps > 1``) and (c)
(``block_matrix``: the block off-diagonal and the inverted N x N flow and
2x2 turbulence diagonal blocks, N = ns + 4, with or without the lagged
term), each in the forms of the models (``sweep_form``), for one species
or a mixture of up to ``MAX_SPECIES``: ns + 4 equations inviscid (Euler)
or viscous (laminar, LES), ns + 6 equations with the SST (sst2003,
sstdes) or the Wilcox 2006 turbulence radii; each with the Rusanov
off-diagonal or, for ``inviscidFluxJacobian: approximateRoe``, the Roe
flux change (``implicit.roe_offdiagonal``, which also reads the cell's
own state; the same vector for the scalar and the block solver, whose
block inverse stays).  The Roe forms replace the JAX package's scan path
of ``roe_offdiagonal`` (it has no Pallas form: its packed sweep stream
lacks the diagonal cell's state) and are built as libraries of their own
(``utils.build.VARIANTS``).  A thermally perfect gas
(``thermodynamicModel: thermallyPerfect``) takes the thermally perfect
forms of the Rusanov off-diagonal, two more libraries
(``lusgs_sweep_tp``, ``blusgs_sweep_tp``; ``csrc/thermo_tp.cuh``): each
species' energy, enthalpy, cv and cp are functions of T and the energy of
q + du is inverted by Ridder's method per neighbour.  They replace the
JAX package's scan sweep of such a deck (its ``use_pallas`` turns the
Pallas kernel off there); its approximateRoe forms are not built (ROADMAP
item 5c: refused on the card).  The plain
version has the semantics of the JAX package's
``lusgs_forward_group`` / ``lusgs_backward_group``, walked in physical
layout through the hyperplane cell lists of ``SweepPlan``
(``solver/implicit.py``).  With ``extra`` (neq, ni, nj, nk), the lagged
term computed outside the sweep (``implicit.offdiag_sum``: the upper sum
for the forward sweep, the lower sum for the backward one):

    forward:  du = D^-1 (b + L - extra)
    backward: du = D^-1 (b + extra - U)      (without: du - D^-1 U)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..physics.models import Physics
from ..solver import implicit as imp
from ..solver import state as st
from ..solver.viscous import SST, WILCOX
from ..unsupported import refuse

# species counts the kernels are instantiated for (MAX_NS of both sources)
MAX_SPECIES = 5
# vibrational modes per species of the thermally perfect forms
# (thermo_tp.cuh MAX_MODES; CH4 has 9)
MAX_MODES = 9


class LaunchCounter:
    """Number of kernel launches (one per block and sweep) since the last
    reset."""

    def __init__(self):
        self.count = 0

    def reset(self):
        self.count = 0


LAUNCHES = LaunchCounter()          # csrc/lusgs_sweep.cu (scalar)
BLOCK_LAUNCHES = LaunchCounter()    # csrc/blusgs_sweep.cu (block)
STATE_RESETS = LaunchCounter()      # cudaMemsetAsync before either


# ---------------------------------------------------------------------------
# plain PyTorch version


def _plain_sweep(phys: Physics, cfg, plan, prim, du, b, inv_f, inv_t, aux,
                 forward: bool, extra=None):
    """One sweep of one block over ``plan``'s hyperplanes; updates du IN
    PLACE (each plane reads only the neighbour plane, already final).
    With ``cfg['block_matrix']`` the off-diagonal is the block form
    (``implicit.offdiagonal_block_channels``, reading the neighbour's
    vgrad) and the inverse the channel-first block diagonal."""
    side = "lower" if forward else "upper"
    blk = bool(cfg.get("block_matrix"))
    roe = cfg.get("inv_flux_jac", "rusanov") == "approximateRoe"
    C = prim.shape[0]
    qf = prim.reshape(C, -1)
    duf = du.view(C, -1)
    viscous = bool(cfg.get("viscous"))
    if viscous:
        muf, mutf, f1f = (aux[k].reshape(-1) for k in ("mu", "mut", "f1"))
    # the Roe form reads no velocity gradient
    vgf = (aux["vgrad"].reshape(9, -1) if blk and viscous and not roe
           else None)
    bf = b.reshape(C, -1)
    ef = extra.reshape(C, -1) if extra is not None else None
    # without turbulence equations there is no turbulence inverse
    if blk:
        invf = inv_f.reshape(inv_f.shape[0], -1)
        invt = None if inv_t is None else inv_t.reshape(4, -1)
        dmul = imp.diag_mult_channels
    else:
        invf = inv_f.reshape(-1)
        invt = None if inv_t is None else inv_t.reshape(-1)
        dmul = imp.diag_mult

    def at(inv, pcells):
        return None if inv is None else inv[..., pcells]
    static, mask = plan.static[side], plan.mask[side]
    strides = plan.strides
    planes = range(plan.nplanes) if forward else range(plan.nplanes - 1,
                                                        -1, -1)
    sign = -1 if forward else 1
    for p in planes:
        s, e = int(plan.plane_ptr[p]), int(plan.plane_ptr[p + 1])
        n = e - s
        cells = plan.cells[s:e]
        pcells = plan.phys_cells[s:e]
        # the three directions' neighbours in one batch, direction-major
        nb = torch.cat([cells + sign * strides[d] for d in range(3)])
        stat = static[pcells].transpose(0, 1).reshape(3 * n, -1)
        kw = {}
        if viscous:
            kw = dict(dist=stat[:, 4], mu=muf[nb], mut=mutf[nb], f1=f1f[nb])
            if vgf is not None:
                kw["vgrad"] = vgf[:, nb].reshape(3, 3, -1)
        if roe:
            # the cell's own state, once per direction
            kw["q_diag"] = qf[:, cells].repeat(1, 3)
        contrib = imp.offdiagonal(phys, cfg, qf[:, nb], duf[:, nb],
                                  stat[:, 0:3].T, stat[:, 3], forward, **kw)
        msk = mask[pcells]
        acc = 0.0
        for d in range(3):
            acc = acc + torch.where(msk[:, d][None],
                                    contrib[:, d * n:(d + 1) * n], 0.0)
        inv = (at(invf, pcells), at(invt, pcells))
        if forward:
            rhs = bf[:, pcells] + acc
            if ef is not None:
                rhs = rhs - ef[:, pcells]
            duf[:, cells] = dmul(phys, *inv, rhs)
        elif ef is not None:
            duf[:, cells] = dmul(phys, *inv,
                                 bf[:, pcells] + ef[:, pcells] - acc)
        else:
            duf[:, cells] = duf[:, cells] - dmul(phys, *inv, acc)
    return du


def forward_plain(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux,
                  extra=None):
    return _plain_sweep(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux,
                        True, extra)


def backward_plain(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux,
                   extra=None):
    return _plain_sweep(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux,
                        False, extra)


# ---------------------------------------------------------------------------
# CUDA kernel


def library_name(block: bool, roe: bool, tp: bool) -> str:
    """the library of a form: the Rusanov, approximateRoe (``_roe``) or
    thermally perfect (``_tp``) build of the scalar or block sweep"""
    return (("blusgs_sweep" if block else "lusgs_sweep")
            + ("_roe" if roe else "_tp" if tp else ""))


def _library(roe: bool, tp: bool):
    from ..utils.build import load_cuda_library
    lib, _ = load_cuda_library(library_name(False, roe, tp))
    fn = lib.lusgs_sweep_f64
    if fn.argtypes is None:
        p, i, ll, dbl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
        fn.argtypes = ([i] * 7 + [p] * 11 + [ll] * 5 + [p] * 3 + [dbl] * 12
                       + [p, p])
        fn.restype = ctypes.c_int
    return fn


def _block_library(roe: bool, tp: bool):
    from ..utils.build import load_cuda_library
    lib, _ = load_cuda_library(library_name(True, roe, tp))
    fn = lib.blusgs_sweep_f64
    if fn.argtypes is None:
        p, i, ll, dbl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
        fn.argtypes = ([i] * 7 + [p] * 12 + [ll] * 5 + [p] * 3 + [dbl] * 18
                       + [p, p])
        fn.restype = ctypes.c_int
    return fn


def _check(t, name, shape, device):
    if t.dtype != torch.float64 or t.device != device:
        raise ValueError(f"{name}: need float64 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def sweep_form(phys: Physics, cfg):
    """(ns, neq, viscous, wilcox, roe, tp) of the kernel instantiation
    this physics and off-diagonal (roe: approximateRoe) take, tp for a
    thermally perfect gas.  A species count above ``MAX_SPECIES`` is
    refused with NotImplementedError naming its ROADMAP.md item, and so is
    a thermally perfect gas with the approximateRoe off-diagonal (no
    library holds that form; its plain version runs on the CPU); a form no
    model has (turbulence equations without viscosity) and a species with
    more than ``MAX_MODES`` vibrational modes in a thermally perfect gas
    raise ValueError."""
    viscous = bool(cfg.get("viscous", False))
    ns, neq = phys.ns, phys.neq
    roe = cfg.get("inv_flux_jac", "rusanov") == "approximateRoe"
    tp = phys.thermally_perfect
    if ns > MAX_SPECIES:
        refuse("species", f"{ns} species")
    if roe and tp:
        refuse("thermallyPerfectRoe", "approximateRoe")
    if ns < 1 or neq not in (ns + 4, ns + 6) or (neq == ns + 6
                                                 and not viscous):
        raise ValueError("the CUDA sweeps cover ns + 4 equations (inviscid "
                         "or viscous) or ns + 6 (viscous RANS) only, got "
                         f"ns={ns} neq={neq} viscous={viscous}")
    if tp and max(len(v) for v in phys.vib) > MAX_MODES:
        raise ValueError("the thermally perfect CUDA sweeps take at most "
                         f"{MAX_MODES} vibrational modes a species, got "
                         f"{[len(v) for v in phys.vib]}")
    return (ns, neq, viscous, phys.turb_model == "kOmegaWilcox2006", roe,
            tp)


def species_constants(phys: Physics, cfg, block: bool) -> np.ndarray:
    """the kernels' host array of the species constants: R_s, cv_s, cp_s,
    hf_s and, for the block sweep, the Sutherland conductivity
    coefficients, the molar masses, the Schmidt numbers and whether the
    species diffuse, then for a thermally perfect gas the vibrational
    table: each species' mode count, then per species ``MAX_MODES``
    nondimensional vibrational temperatures padded with 0 (the
    ``launch_form`` of each source)"""
    vals = [*phys.R, *phys.cv_s, *phys.cp_s, *phys.hf]
    if block:
        vals += [*phys.cond_c1, *phys.cond_s, *phys.molar_mass,
                 cfg.get("schmidt", 0.9), cfg.get("turb_schmidt", 0.7),
                 float(cfg.get("diffusion", "none") != "none")]
    if phys.thermally_perfect:
        vals += [float(len(v)) for v in phys.vib]
        for v in phys.vib:
            vals += [*v, *([0.0] * (MAX_MODES - len(v)))]
    return np.asarray(vals, dtype=np.float64)


def _check_operands(phys: Physics, cfg, plan, prim, du, b, inv_f, inv_t,
                    aux, extra):
    """Raise ValueError unless the operands are what the kernel of this
    solver (scalar or block) and this physics reads."""
    ns, neq, viscous, _, roe, _ = sweep_form(phys, cfg)
    nturb = neq - ns - 4
    dev = prim.device
    NI, NJ, NK = plan.padded
    ni, nj, nk = plan.dims
    _check(prim, "prim", (neq, NI, NJ, NK), dev)
    _check(du, "du", (neq, NI, NJ, NK), dev)
    if viscous:
        for k in ("mu", "mut", "f1"):
            _check(aux[k], k, (NI, NJ, NK), dev)
    _check(b, "b", (neq, ni, nj, nk), dev)
    if cfg.get("block_matrix"):
        if viscous and not roe:
            _check(aux["vgrad"], "vgrad", (3, 3, NI, NJ, NK), dev)
        _check(inv_f, "inv_f", ((ns + 4) ** 2, ni, nj, nk), dev)
        inv_t_shape = (4, ni, nj, nk)
    else:
        _check(inv_f, "inv_f", (ni, nj, nk), dev)
        inv_t_shape = (ni, nj, nk)
    if nturb:
        _check(inv_t, "inv_t", inv_t_shape, dev)
    elif inv_t is not None:
        raise ValueError("inv_t: no turbulence inverse without turbulence "
                         "equations")
    if extra is not None:
        _check(extra, "extra", (neq, ni, nj, nk), dev)


def _kernel_sweep(phys: Physics, cfg, plan, prim, du, b, inv_f, inv_t, aux,
                  forward: bool, extra=None):
    _check_operands(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, extra)
    ns, neq, viscous, wilcox, roe, tp = sweep_form(phys, cfg)
    blk = bool(cfg.get("block_matrix"))
    NI, NJ, NK = plan.padded
    ni, nj, nk = plan.dims
    side = "lower" if forward else "upper"
    # the first species' scalars: the calorically perfect one-species
    # forms read these, a mixture and the thermally perfect forms their
    # species array (whose gamma is a function of T: NaN here, so that a
    # read would show)
    R, cv, cp, hf = phys.R[0], phys.cv_s[0], phys.cp_s[0], phys.hf[0]
    g = float("nan") if tp else cp / cv
    pr = 4.0 * g / (9.0 * g - 5.0)
    species = species_constants(phys, cfg, blk)
    stream = torch.cuda.current_stream(prim.device).cuda_stream
    sched = np.asarray([len(plan.tiles), ni, nj, nk, *plan.tile, plan.g],
                       dtype=np.int32)
    # the mask is bool: one byte, 0 or 1, as the kernels' uint8
    geometry = (plan.static[side].data_ptr(), plan.mask[side].data_ptr(),
                NI * NJ * NK, ni * nj * nk, *plan.strides,
                sched.ctypes.data, plan.tiles.data_ptr(),
                plan.tile_state.data_ptr())

    def ptr(t):
        return None if t is None else t.data_ptr()

    form = (int(forward), ns, neq, int(viscous), int(wilcox), int(roe),
            int(tp))
    fields = (prim.data_ptr(), du.data_ptr(),
              *(ptr(aux[k]) if viscous else None
                for k in ("mu", "mut", "f1")))
    # the model's constants: Wilcox has sigma* and sigma where SST blends
    sig = ((WILCOX["sigma_star"], WILCOX["sigma_star"], WILCOX["sigma"],
            WILCOX["sigma"]) if wilcox else
           (SST["sigma_k1"], SST["sigma_k2"], SST["sigma_w1"],
            SST["sigma_w2"]))
    if blk:
        name = "blusgs_sweep_f64"
        err = _block_library(roe, tp)(
            *form, *fields,
            ptr(aux["vgrad"]) if viscous and not roe else None,
            b.data_ptr(), ptr(extra), inv_f.data_ptr(), ptr(inv_t),
            *geometry, R, cv, cp, hf, g, pr, phys.turb_prandtl(),
            phys.nondim_scaling, *phys.turb_min(), phys.t_ref,
            phys.cond_c1[0], phys.cond_s[0], phys.k_nondim, *sig,
            species.ctypes.data, stream)
        counter = BLOCK_LAUNCHES
    else:
        name = "lusgs_sweep_f64"
        err = _library(roe, tp)(
            *form, *fields, b.data_ptr(), ptr(extra),
            inv_f.data_ptr(), ptr(inv_t), *geometry, R, cv, cp, hf, g, pr,
            phys.turb_prandtl(), phys.nondim_scaling, *phys.turb_min(),
            *sig[:2], species.ctypes.data, stream)
        counter = LAUNCHES
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    STATE_RESETS.count += 1
    counter.count += 1
    return du


# FP64 operations counted from the kernels (each add, subtract, multiply,
# divide, sqrt, pow, abs, min or max as one) per contributing neighbour's
# off-diagonal product, by one-species form (neq, viscous, wilcox); a
# cell's final update takes 2 per equation (the lagged term adds one per
# equation).  csrc/lusgs_sweep.cu: update_prim 47 (39 with 5 equations),
# two physical_flux 60 (56), v.n and the speed of sound 8, the inviscid
# radius 4, the flow rows 35; viscous adds max_term and the viscous radius
# 12; 7 equations add the turbulence radius and rows: 22 with the SST
# blend, 20 for Wilcox (no blend, the unlimited rho k / omega).
NEIGHBOUR_OPS_BY_FORM = {(5, False, False): 142, (5, True, False): 154,
                         (7, True, False): 188, (7, True, True): 186}
# csrc/blusgs_sweep.cu: the state and the Rusanov block rows (155), the TSL
# rows with the stress vector and dPrim/dCons (127; 125 without the
# turbulent conductivity of 5 equations), the turbulence diagonal (30 with
# the SST blends, 24 for Wilcox).  A block cell's right-hand side and its
# N x N (+ 2x2) inverse product take 2 N^2 + N (+ 8).
BLOCK_NEIGHBOUR_OPS_BY_FORM = {(5, False, False): 155, (5, True, False): 280,
                               (7, True, False): 312, (7, True, True): 306}
# csrc/roe_offdiag.cuh add_roe_offdiagonal, the same for both kernels:
# update_prim 47 (39 with 5 equations), two roe_flux 542 (446), each the
# Roe average, its enthalpy and speed of sound and the state differences
# 51, the waves' dissipation rows 139 (101), two physical fluxes 60 (56)
# and the combine 21 (15); the flux change 14 (10), and the rows into
# the sum 7 (5) inviscid; viscous: max_term and the flow radius 11, each
# row 4, the turbulence radius 10 with the SST blend, 8 for Wilcox
ROE_NEIGHBOUR_OPS_BY_FORM = {(5, False, False): 500, (5, True, False): 526,
                             (7, True, False): 652, (7, True, True): 650}
SST_FORM = (1, 7, True, False, False, False)
# the turbulence rows of a neighbour (SST blend, Wilcox), both kernels
TURB_OPS = {False: 22, True: 20}
BLOCK_TURB_OPS = {False: 30, True: 24}


def roe_mixture_neighbour_ops(form) -> int:
    """FP64 operations per contributing neighbour of a mixture's Roe form
    (csrc/roe_offdiag.cuh, scalar and block alike): q + du 23 ns + 30 (+4
    per turbulence equation), two Roe fluxes of 46 ns + 181 + 3 neq (+21
    per turbulence equation: its wave rows and its flux row), the flux
    change 2 neq; inviscid the rows into the sum, neq; viscous the state's
    gamma and Prandtl number 7 ns + 5, max_term and the flow radius 11,
    each row 4, the turbulence radius 10 (SST) or 8 (Wilcox)."""
    ns, neq, viscous, wilcox = form[:4]
    nt = neq - ns - 4
    flux = 46 * ns + 181 + 3 * neq + 21 * nt
    ops = 23 * ns + 30 + 4 * nt + 2 * flux + 2 * neq
    if not viscous:
        return ops + neq
    return (ops + 7 * ns + 16 + 4 * neq
            + ((8 if wilcox else 10) if nt else 0))


def mixture_neighbour_ops(form, block: bool, diffusion: bool) -> int:
    """FP64 operations per contributing neighbour of a mixture's form
    (ns, neq, viscous, wilcox), counted from the kernels' mixture paths.
    Scalar (update_prim_mix, physical_flux_mix, add_offdiagonal): q + du
    with the species renormalisation and the mixture energy 23 ns + 30
    (+8 for the turbulence rows), two fluxes 18 ns + 48 (+4), gamma from
    the mixture's cp and cv 6 ns + 1 and, when viscous, the state's
    Prandtl number 4, v.n, the speed of sound and the inviscid radius 12,
    the ns + 4 flow rows 7 each, the viscous radius 12, the turbulence
    radius and rows.  Block (add_block_offdiagonal_mix): the state with
    its mixture sums 13 ns + 13, the Rusanov rows 11 ns + 135, the TSL
    rows with the mixture's conductivity 12 ns + 127 (+3 for the
    turbulent conductivity), Schmidt diffusion's species rows and
    enthalpy flux 14 ns + 4, the turbulence diagonal."""
    ns, neq, viscous, wilcox = form[:4]
    turb = neq == ns + 6
    if block:
        ops = 24 * ns + 148
        if viscous:
            ops += 12 * ns + 127 + (3 if turb else 0)
            ops += (14 * ns + 4) if diffusion else 0
        return ops + (BLOCK_TURB_OPS[wilcox] if turb else 0)
    ops = 54 * ns + 119 + (16 if viscous else 0)
    return ops + ((12 + TURB_OPS[wilcox]) if turb else 0)


def tp_extra_ops(form, modes, ridder_iters: float, block: bool,
                 diffusion: bool) -> float:
    """FP64 operations per contributing neighbour that a thermally perfect
    form (csrc/thermo_tp.cuh) adds to ``mixture_neighbour_ops`` (every
    species count takes the mixture path there); ``modes`` the species'
    vibrational mode counts, ``ridder_iters`` the mean Ridder iterations
    of this run's states (``mean_ridder_iterations``).  Per species and T:
    its energy or enthalpy adds 2 + 5 per mode to the calorically perfect
    one (each mode theta / T, exp, - 1, a division and the sum), its cv
    and cp 3 + 6 per mode (2 T, theta / 2 T, sinh, the quotient, its
    square and the sum).  Scalar: the energy of q and the enthalpies of
    the two fluxes, cp and cv of the neighbour, and Ridder's inversion in
    place of the closed form (4 ns + 2): 2 + 2 iterations energy
    evaluations, each sum_s (4 + 5 m_s) (+ 2 ns for a mixture), 19 for
    each iteration's bracket and ns for the mass fractions.  Block (no
    q + du): cp and cv, the energy and, with diffusion, the species
    enthalpies."""
    ns = form[0]
    e_extra = sum(2 + 5 * m for m in modes)
    cpcv = sum(3 + 6 * m for m in modes)
    if block:
        return cpcv + e_extra + (e_extra if diffusion else 0)
    evaluation = sum(4 + 5 * m for m in modes) + (2 * ns if ns > 1 else 0)
    ridder = ((2 + 2 * ridder_iters) * evaluation + 19 * ridder_iters + ns
              - (4 * ns + 2))
    return 3 * e_extra + cpcv + ridder


def mean_ridder_iterations(phys: Physics, prim, du) -> float:
    """mean over the cells of the Ridder iterations that inverting the
    energy of prim + du (in conserved variables, the sweep's q + du) takes
    (``Physics._ridder_temperature``); prim and du (neq, ...)"""
    cons = st.cons_from_prim(phys, prim) + du
    r = cons[:phys.ns].sum(dim=0)
    vel = cons[phys.mx:phys.mx + 3] / r[None]
    e = cons[phys.ie] / r - 0.5 * (vel * vel).sum(dim=0)
    mf = st.mixture_fractions(phys, cons)
    return float(phys._ridder_temperature(e, mf, count=True)[1].mean())


def _neighbours(plan, forward: bool):
    """(per physical cell in plane order, whether each direction's face on
    the sweep side is unmasked; the distinct padded cells read across
    those faces)"""
    mask = plan.mask["lower" if forward else "upper"][plan.phys_cells]
    sign = -1 if forward else 1
    return mask, torch.unique(torch.cat([plan.cells[mask[:, d]]
                                         + sign * plan.strides[d]
                                         for d in range(3)]))


def neighbour_reads(plan, forward: bool):
    """(distinct padded cells read as neighbours across the unmasked faces
    of the sweep side, how many of them are ghosts)."""
    _, nbs = _neighbours(plan, forward)
    return nbs.numel(), nbs.numel() - int(torch.isin(nbs, plan.cells).sum())


def own_reads(plan, forward: bool) -> int:
    """cells with an unmasked face on the sweep side that are not read as
    a neighbour across one (the Roe form's own state)"""
    mask, nbs = _neighbours(plan, forward)
    return int((~torch.isin(plan.cells[mask.any(dim=1)], nbs)).sum())


def sweep_cost(plan, forward: bool, with_extra: bool = False,
               block: bool = False, form=SST_FORM, diffusion: bool = False,
               modes=(), ridder_iters: float = 0.0):
    """(bytes, FP64 operations) of one sweep of one block over ``plan``,
    each value the sweep needs read once and du's physical cells written
    once, for the kernel form ``form`` = (ns, neq, viscous, wilcox, roe,
    tp) of ``sweep_form`` (``diffusion``: a block mixture's Schmidt
    diffusion rows; ``modes`` and ``ridder_iters``: a thermally perfect
    form's vibrational mode counts and mean Ridder iterations,
    ``tp_extra_ops``).  Reads: prim and, when viscous, mu, mut, f1 (not without
    turbulence equations or for Wilcox) and for the block sweep's Rusanov
    form vgrad at the distinct neighbours across this run's unmasked
    faces; the Roe form also reads prim at the cells with an unmasked face
    that are not read as neighbours; du's input
    where the sweep has not rewritten it first (the ghost neighbours, and
    every cell of a backward sweep without extra: du - D^-1 U); per cell
    the inverses (the scalar one or the (ns + 4)^2 block channels, the
    turbulence one only with turbulence equations), b (not in that
    backward form), extra and the masks; the face statics of
    the unmasked faces (the centre distance only when viscous).
    Operations: the kernel's per contributing neighbour and per cell
    (+neq with extra)."""
    ns, neq, viscous, wilcox, roe, tp = form
    N = ns + 4
    turb = neq == N + 2
    side = "lower" if forward else "upper"
    mask = plan.mask[side]
    ncell = int(plan.cells.numel())
    nfaces = int(mask.sum())
    nread, nghost = neighbour_reads(plan, forward)
    plain_backward = not forward and not with_extra
    padded = neq
    if viscous:
        padded += 2 + (1 if turb and not wilcox else 0) \
            + (9 if block and not roe else 0)
    inverses = ((N * N if block else 1)
                + ((4 if block else 1) if turb else 0))
    per_cell_in = (inverses + (0 if plain_backward else neq)
                   + (neq if with_extra else 0))
    nstat = plan.static[side].shape[-1] - (0 if viscous else 1)
    values = (padded * nread + (neq * own_reads(plan, forward) if roe else 0)
              + neq * (nghost + (ncell if plain_backward else 0))
              + per_cell_in * ncell
              + nstat * nfaces
              + neq * ncell)
    nbytes = 8 * values + mask.numel()
    if roe:
        per_nb = (ROE_NEIGHBOUR_OPS_BY_FORM[(neq, viscous, wilcox)]
                  if ns == 1 else roe_mixture_neighbour_ops(form))
    elif ns == 1 and not tp:
        key = (neq, viscous, wilcox)
        per_nb = (BLOCK_NEIGHBOUR_OPS_BY_FORM if block
                  else NEIGHBOUR_OPS_BY_FORM)[key]
    else:
        per_nb = mixture_neighbour_ops(form, block, diffusion)
        if tp:
            per_nb += tp_extra_ops(form, modes, ridder_iters, block,
                                   diffusion)
    per_cell = 2 * N * N + N + (8 if turb else 0) if block else 2 * neq
    ops = per_nb * nfaces + (per_cell + (neq if with_extra else 0)) * ncell
    return nbytes, ops


# ---------------------------------------------------------------------------
# entry points

# side streams by device, one per block of a sweep (sweep_blocks)
_STREAMS: dict = {}


def _sweep(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, forward, extra):
    if du.device.type == "cpu":
        return _plain_sweep(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux,
                            forward, extra)
    if du.device.type != "cuda":
        raise ValueError(f"no LU-SGS sweep for device {du.device}")
    return _kernel_sweep(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux,
                         forward, extra)


def forward(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, extra=None):
    """Forward LU-SGS sweep of one block; updates and returns du (in
    place).  prim/du (neq, NI, NJ, NK), b and the optional lagged term
    extra (neq, ni, nj, nk), aux['mu'|'mut'|'f1'] (NI, NJ, NK); scalar
    inverses inv_f/inv_t (ni, nj, nk), or for the block solver the
    channel-first inverse blocks inv_f ((ns + 4)^2, ni, nj, nk) and inv_t
    (4, ni, nj, nk) (``implicit.blk_to_channels``) and aux['vgrad'] (3, 3,
    NI, NJ, NK)."""
    return _sweep(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, True,
                  extra)


def backward(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, extra=None):
    """Backward LU-SGS sweep of one block; updates and returns du (in
    place)."""
    return _sweep(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, False,
                  extra)


def sweep_blocks(phys, cfg, blocks, forward: bool):
    """One sweep, forward or backward, of every block: ``blocks`` holds per
    block (plan, prim, du, b, inv_f, inv_t, aux, extra).  The blocks of one
    sweep are independent (their connection ghosts were swapped before it),
    so on the card each block's launch goes on a stream of its own, after
    the work queued on the current stream and joined back to it before
    this returns; on the CPU they run one after another.  A temporary the
    caller frees after the return (the lagged term) is reused only by work
    queued after that join, so the side streams need no record_stream.
    On a rank of a multi-rank run ``blocks`` are that rank's own whole
    blocks, the TPU kernel's variant (d) (``pallas_sweep.py:362-378``); a
    rank with one block launches on one side stream."""
    if not blocks or blocks[0][2].device.type != "cuda":
        for plan, prim, du, b, inv_f, inv_t, aux, extra in blocks:
            _sweep(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, forward,
                   extra)
        return
    dev = blocks[0][2].device
    main = torch.cuda.current_stream(dev)
    streams = _STREAMS.setdefault(dev, [])
    while len(streams) < len(blocks):
        streams.append(torch.cuda.Stream(dev))
    for stream, args in zip(streams, blocks):
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            _sweep(phys, cfg, *args[:-1], forward, args[-1])
    for stream in streams[:len(blocks)]:
        main.wait_stream(stream)
