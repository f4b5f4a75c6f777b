"""LU-SGS hyperplane sweeps: the hand-written CUDA kernel and its plain
PyTorch version.

``forward`` / ``backward`` sweep one block in place.  On a CPU tensor they
run the plain PyTorch version (``forward_plain`` / ``backward_plain``); on
a CUDA tensor they launch ``csrc/lusgs_sweep.cu`` (built at first use) and
raise if it cannot run — there is no fallback.  ``LAUNCHES`` counts the
kernel's launches (one per hyperplane).

Replaces the TPU kernel ``aither_tpu/solver/pallas_sweep.py::sweep``,
variants (a) (scalar LU-SGS, one species, SST, no lagged term) and (b)
(``with_extra``: the lagged opposite-side term of ``matrixSweeps > 1``).
The plain version has the semantics of the JAX package's
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

from ..physics.models import Physics, prandtl
from ..solver import implicit as imp
from ..solver.viscous import SST


class LaunchCounter:
    """Number of kernel launches (hyperplanes swept) since the last reset."""

    def __init__(self):
        self.count = 0

    def reset(self):
        self.count = 0


LAUNCHES = LaunchCounter()


# ---------------------------------------------------------------------------
# plain PyTorch version


def _plain_sweep(phys: Physics, cfg, plan, prim, du, b, inv_f, inv_t, aux,
                 forward: bool, extra=None):
    """One sweep of one block over ``plan``'s hyperplanes; updates du IN
    PLACE (each plane reads only the neighbour plane, already final)."""
    side = "lower" if forward else "upper"
    C = prim.shape[0]
    qf = prim.reshape(C, -1)
    duf = du.view(C, -1)
    muf, mutf, f1f = (aux[k].reshape(-1) for k in ("mu", "mut", "f1"))
    bf = b.reshape(C, -1)
    ef = extra.reshape(C, -1) if extra is not None else None
    invf, invt = inv_f.reshape(-1), inv_t.reshape(-1)
    static, mask = plan.static[side], plan.mask[side]
    strides = plan.strides
    planes = range(plan.nplanes) if forward else range(plan.nplanes - 1,
                                                        -1, -1)
    for p in planes:
        s, e = int(plan.plane_ptr[p]), int(plan.plane_ptr[p + 1])
        cells = plan.cells[s:e]
        pcells = plan.phys_cells[s:e]
        acc = 0.0
        for d in range(3):
            nb = cells - strides[d] if forward else cells + strides[d]
            stat = static[s:e, d]
            contrib = imp.offdiagonal_scalar(
                phys, cfg, qf[:, nb], duf[:, nb], stat[:, 0:3].T,
                stat[:, 3], forward, dist=stat[:, 4], mu=muf[nb],
                mut=mutf[nb], f1=f1f[nb])
            acc = acc + torch.where(mask[s:e, d][None], contrib, 0.0)
        inv = (invf[pcells], invt[pcells])
        if forward:
            rhs = bf[:, pcells] + acc
            if ef is not None:
                rhs = rhs - ef[:, pcells]
            duf[:, cells] = imp.diag_mult(phys, *inv, rhs)
        elif ef is not None:
            duf[:, cells] = imp.diag_mult(
                phys, *inv, bf[:, pcells] + ef[:, pcells] - acc)
        else:
            duf[:, cells] = duf[:, cells] - imp.diag_mult(phys, *inv, acc)
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


def _library():
    from ..utils.build import load_cuda_library
    lib, _ = load_cuda_library("lusgs_sweep")
    fn = lib.lusgs_sweep_f64
    if fn.argtypes is None:
        p, i, ll, dbl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_double)
        fn.argtypes = ([i] + [p] * 13 + [ll] * 5 + [i, p] + [dbl] * 12
                       + [p])
        fn.restype = ctypes.c_int
    return fn


def _kernel_operands(plan):
    """int32 / uint8 device copies of the plan's lists the kernel reads,
    built once per plan."""
    ops = plan.kernel_ops
    if ops is None:
        ops = dict(
            cells=plan.cells.to(torch.int32).contiguous(),
            phys_cells=plan.phys_cells.to(torch.int32).contiguous(),
            plane_ptr=np.ascontiguousarray(plan.plane_ptr, dtype=np.int32),
            mask={s: m.to(torch.uint8).contiguous()
                  for s, m in plan.mask.items()},
            static={s: t.contiguous() for s, t in plan.static.items()})
        plan.kernel_ops = ops
    return ops


def _check(t, name, shape, device):
    if t.dtype != torch.float64 or t.device != device:
        raise ValueError(f"{name}: need float64 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _kernel_sweep(phys: Physics, cfg, plan, prim, du, b, inv_f, inv_t, aux,
                  forward: bool, extra=None):
    if phys.neq != 7 or phys.ns != 1 or phys.turb_model != "sst2003" \
            or not cfg.get("viscous", False):
        raise ValueError("the CUDA sweep covers one species SST 2003 "
                         "(7 equations, viscous) only")
    dev = prim.device
    NI, NJ, NK = plan.padded
    ni, nj, nk = plan.dims
    _check(prim, "prim", (7, NI, NJ, NK), dev)
    _check(du, "du", (7, NI, NJ, NK), dev)
    for k in ("mu", "mut", "f1"):
        _check(aux[k], k, (NI, NJ, NK), dev)
    _check(b, "b", (7, ni, nj, nk), dev)
    _check(inv_f, "inv_f", (ni, nj, nk), dev)
    _check(inv_t, "inv_t", (ni, nj, nk), dev)
    if extra is not None:
        _check(extra, "extra", (7, ni, nj, nk), dev)
    ops = _kernel_operands(plan)
    side = "lower" if forward else "upper"
    fn = _library()
    g = phys.gamma_const
    err = fn(int(forward), prim.data_ptr(), du.data_ptr(),
             aux["mu"].data_ptr(), aux["mut"].data_ptr(),
             aux["f1"].data_ptr(), b.data_ptr(),
             extra.data_ptr() if extra is not None else None,
             inv_f.data_ptr(),
             inv_t.data_ptr(), ops["cells"].data_ptr(),
             ops["phys_cells"].data_ptr(), ops["static"][side].data_ptr(),
             ops["mask"][side].data_ptr(), NI * NJ * NK, ni * nj * nk,
             *plan.strides, plan.nplanes,
             ops["plane_ptr"].ctypes.data, phys.R, phys.cv, phys.cp,
             phys.hf, g, prandtl(phys), phys.turb_prandtl(),
             phys.nondim_scaling, *phys.turb_min(), SST["sigma_k1"],
             SST["sigma_k2"], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lusgs_sweep_f64: CUDA error {err} at launch")
    LAUNCHES.count += plan.nplanes
    return du


# FP64 operations counted from csrc/lusgs_sweep.cu (each add, subtract,
# multiply, divide, sqrt, abs, min or max as one): one contributing
# neighbour's off-diagonal product, and a cell's final update (the lagged
# term adds one operation per equation)
NEIGHBOUR_OPS = 188
CELL_OPS = 14


def sweep_cost(plan, forward: bool, with_extra: bool = False):
    """(bytes, FP64 operations) of one sweep of one block over ``plan``:
    each input read once (prim, du, mu, mut, f1 padded; b, inv_f, inv_t,
    extra, the cell lists, the face statics and masks of the sweep side),
    du's physical cells written once; NEIGHBOUR_OPS per contributing
    neighbour of this run's masks, CELL_OPS (+7 with extra) per cell."""
    side = "lower" if forward else "upper"
    ncell = int(plan.cells.numel())
    npad = int(np.prod(plan.padded))
    neq = 7
    values = ((2 * neq + 3) * npad + (neq + 2) * ncell
              + plan.static[side].numel() + neq * ncell
              + (neq * ncell if with_extra else 0))
    nbytes = 8 * values + 2 * 4 * ncell + plan.mask[side].numel()
    ops = (NEIGHBOUR_OPS * int(plan.mask[side].sum())
           + (CELL_OPS + (neq if with_extra else 0)) * ncell)
    return nbytes, ops


def empty_planes(n: int, device) -> None:
    """n launches of an empty sweep plane on ``device``'s current stream,
    from the same host loop as a sweep: the floor under one dependent plane
    launch (timed by chip_smoke.py; not counted in LAUNCHES)."""
    from ..utils.build import load_cuda_library
    lib, _ = load_cuda_library("lusgs_sweep")
    fn = lib.lusgs_sweep_empty_planes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(n, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lusgs_sweep_empty_planes: CUDA error {err}")


# ---------------------------------------------------------------------------
# entry points


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
    extra (neq, ni, nj, nk), inv_f/inv_t (ni, nj, nk),
    aux['mu'|'mut'|'f1'] (NI, NJ, NK)."""
    return _sweep(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, True,
                  extra)


def backward(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, extra=None):
    """Backward LU-SGS sweep of one block; updates and returns du (in
    place)."""
    return _sweep(phys, cfg, plan, prim, du, b, inv_f, inv_t, aux, False,
                  extra)
