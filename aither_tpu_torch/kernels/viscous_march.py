"""The fused viscous residual: the hand-written CUDA kernel and its plain
PyTorch version.

``viscous_residual(phys, cfg, block, prim, t_all, mu_all)`` returns what
``solver/viscous.viscous_residual`` returns: (resid, sr_flow, sr_turb,
diag_flow, diag_turb, cellavg) with cellavg's 'vel', 'tke', 'omega', 'mut',
'f1' and 'f2'.  On a CPU tensor it runs that plain version; on a CUDA
tensor it launches ``csrc/viscous_march.cu`` (built at first use), one
launch per block, and raises if it cannot run — there is no fallback.
``LAUNCHES`` counts the kernel's launches.

Replaces the TPU kernel
``aither_tpu/solver/pallas_residual.py::viscous_residual_march`` (SST 2003
branch).  Both versions read the block's static face geometry
(``solver/viscous.viscous_statics``), built once per block.  Scope, as the
JAX package's ``use_march``: one species, scalar solver, central viscous
reconstruction, no wall law, calorically perfect gas (the port's Physics
refuses the others), no pressure-gradient output; the wrapper raises
outside it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..physics.models import Physics
from ..solver import viscous as vis
from ..solver.viscous import SST
from .lusgs_sweep import LaunchCounter

LAUNCHES = LaunchCounter()

# output channels of the kernel, in order (29 for SST)
OUT_CHANNELS = (("resid", 7), ("sr_flow", 1), ("sr_turb", 1),
                ("diag_flow", 1), ("diag_turb", 1), ("vel", 9), ("tke", 3),
                ("omega", 3), ("mut", 1), ("f1", 1), ("f2", 1))

# FP64 operations per face and per cell, counted from csrc/viscous_march.cu
# (each add, subtract, multiply, divide, sqrt, pow, tanh, min or max as
# one): the least work of one residual, each face evaluated once
FACE_OPS = 519
CELL_OPS = 287


def _check_scope(phys: Physics, cfg):
    """Raise ValueError outside the kernel's scope (pallas_residual
    use_march's conditions for the SST branch)."""
    if (phys.ns != 1 or phys.neq != 7 or phys.turb_model != "sst2003"
            or not cfg.get("viscous") or not cfg.get("turbulent")
            or cfg.get("block_matrix")
            or cfg.get("viscous_recon", "central") != "central"):
        raise ValueError(
            "the viscous residual kernel covers one species SST 2003 "
            "(7 equations, viscous, central reconstruction, scalar solver) "
            "only")


def viscous_residual(phys: Physics, cfg, block, prim, t_all, mu_all):
    """Viscous residual of one block (see the module docstring).
    prim (7, NI, NJ, NK) after the viscous ghost fill, t_all and mu_all
    (NI, NJ, NK)."""
    _check_scope(phys, cfg)
    if prim.device.type == "cpu":
        return vis.viscous_residual(phys, cfg, block, prim, t_all, mu_all)
    if prim.device.type != "cuda":
        raise ValueError(f"no viscous residual for device {prim.device}")
    return _kernel(phys, cfg, block, prim, t_all, mu_all)


# ---------------------------------------------------------------------------
# CUDA kernel


def _library():
    from ..utils.build import load_cuda_library
    lib, _ = load_cuda_library("viscous_march")
    fn = lib.viscous_march_f64
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 4 + [p, p]
        fn.restype = ctypes.c_int
    return fn


def _params(phys: Physics, cfg) -> np.ndarray:
    """the kernel's parameters, in the order of its struct Params"""
    return np.array([
        phys.nondim_scaling, phys.R, phys.cp, phys.gamma_const,
        phys.cond_c1, phys.cond_s, phys.t_ref, phys.k_nondim,
        *phys.turb_min(), cfg["viscous_cfl_coeff"],
        SST["beta_star"], SST["sigma_k1"], SST["sigma_k2"], SST["sigma_w1"],
        SST["sigma_w2"], SST["a1"], SST["prt"]], dtype=np.float64)


def _check(t, name, shape, device):
    if t.dtype != torch.float64 or t.device != device:
        raise ValueError(f"{name}: need float64 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def split_outputs(out):
    """(29, ni, nj, nk) kernel output -> the viscous_residual tuple
    (views)."""
    parts, c = {}, 0
    for name, k in OUT_CHANNELS:
        parts[name] = out[c:c + k] if k > 1 else out[c]
        c += k
    cellavg = {key: parts[key] for key in ("tke", "omega", "mut", "f1",
                                           "f2")}
    cellavg["vel"] = parts["vel"].reshape((3, 3) + out.shape[1:])
    return (parts["resid"], parts["sr_flow"], parts["sr_turb"],
            parts["diag_flow"], parts["diag_turb"], cellavg)


def _kernel(phys: Physics, cfg, block, prim, t_all, mu_all):
    dev = prim.device
    ni, nj, nk, g = block.ni, block.nj, block.nk, block.g
    _check(prim, "prim", (7,) + block.shape, dev)
    _check(t_all, "t_all", block.shape, dev)
    _check(mu_all, "mu_all", block.shape, dev)
    statics = vis.viscous_statics(block)
    face = [statics["face"][d] for d in "ijk"]
    for a, arr in enumerate(face):
        fshape = [ni, nj, nk]
        fshape[a] += 1
        _check(arr, f"face statics {'ijk'[a]}", [26] + fshape, dev)
    _check(statics["cell"], "cell statics", (4, ni, nj, nk), dev)
    out = torch.empty((sum(k for _, k in OUT_CHANNELS), ni, nj, nk),
                      dtype=torch.float64, device=dev)
    params = _params(phys, cfg)
    err = _library()(prim.data_ptr(), t_all.data_ptr(), mu_all.data_ptr(),
                     *(f.data_ptr() for f in face),
                     statics["cell"].data_ptr(), out.data_ptr(), ni, nj, nk,
                     g, params.ctypes.data,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"viscous_march_f64: CUDA error {err} at launch")
    LAUNCHES.count += 1
    return split_outputs(out)


def cost(block):
    """(bytes, FP64 operations) of one residual of ``block``: each input
    (prim, T, mu, face and cell statics) read once, each output written
    once; FACE_OPS per face and CELL_OPS per cell."""
    statics = vis.viscous_statics(block)
    ncell = block.ni * block.nj * block.nk
    npad = int(np.prod(block.shape))
    faces = sum(int(np.prod(statics["face"][d].shape[1:])) for d in "ijk")
    values = (9 * npad + sum(statics["face"][d].numel() for d in "ijk")
              + statics["cell"].numel()
              + sum(k for _, k in OUT_CHANNELS) * ncell)
    return 8 * values, FACE_OPS * faces + CELL_OPS * ncell
