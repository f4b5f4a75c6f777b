"""The fused viscous residual: the hand-written CUDA kernel and its plain
PyTorch version.

``viscous_residual(phys, cfg, block, prim, t_all, mu_all)`` returns what
``solver/viscous.viscous_residual`` returns: (resid, sr_flow, sr_turb,
diag_flow, diag_turb, cellavg) with cellavg's 'vel', 'mut', 'f1' and 'f2'
and, with turbulence equations, 'tke' and 'omega'.  On a CPU tensor it runs that plain version; on a CUDA
tensor it launches ``csrc/viscous_march.cu`` (built at first use), one
launch per block in tiles of ``viscous_tile``, and raises if it cannot run
— there is no fallback.
``LAUNCHES`` counts the kernel's launches.

Replaces the TPU kernel
``aither_tpu/solver/pallas_residual.py::viscous_residual_march`` with its
four eddy-viscosity branches (``MODELS``): SST 2003 and SST-DES, k-omega
Wilcox 2006, WALE and laminar, each an instantiation of the kernel.  Both
versions read the block's static face geometry
(``solver/viscous.viscous_statics``, with the face length for WALE), built
once per block.  Scope, as the JAX package's ``use_march``: one species,
scalar solver, central viscous reconstruction, no wall-law surface on the
block, calorically perfect gas, no pressure-gradient output (no nonreflecting LODI surface in the deck,
``cfg['need_pgrad']``); the wrapper raises outside it, on every device:
such a residual takes ``solver/viscous.viscous_residual`` by the solver's
own choice (``solver/step.full_residual``), as in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..physics.models import Physics
from ..solver import viscous as vis
from ..solver.viscous import SST, WALE, WILCOX
from .lusgs_sweep import LaunchCounter

LAUNCHES = LaunchCounter()
# None, or a list that collects, for every launch, three CUDA events: before
# the output's allocation, before the launch and after it (a measurement
# hook: the solver's own launches timed where they run)
TIMINGS = None

# turbulence model -> the kernel's eddy-viscosity branch (enum Model of
# csrc/viscous_march.cu); "none" is the laminar branch
MODELS = {"sst2003": 0, "sstdes": 0, "kOmegaWilcox2006": 1, "wale": 2,
          "none": 3}


def out_channels(nturb: int):
    """output channels of the kernel, in order: 29 with turbulence
    equations, 21 without (no 'tke' / 'omega' gradient averages)"""
    turb = (("tke", 3), ("omega", 3)) if nturb else ()
    return ((("resid", 5 + nturb), ("sr_flow", 1), ("sr_turb", 1),
             ("diag_flow", 1), ("diag_turb", 1), ("vel", 9)) + turb
            + (("mut", 1), ("f1", 1), ("f2", 1)))


# FP64 operations per face and per cell by branch, counted from
# csrc/viscous_march.cu (each add, subtract, multiply, divide, sqrt, pow,
# tanh, min or max as one): the least work of one residual, each face
# evaluated once.  SST: the face state 26, six CV gradients 312, the eddy
# viscosity and blending 83, stresses and fluxes 98.  Wilcox: the limiter
# 50 instead of 83, the unlimited mut 3 instead of the two sigma blends 8.
# Laminar: 5 equations (state 18, four gradients 208), no eddy viscosity,
# no k / omega fluxes (67).  WALE: laminar plus Sd:Sd, S:S and the three
# pow 134, and the eddy viscosity's part in the stresses 5.
FACE_OPS_BY_MODEL = {0: 519, 1: 481, 2: 432, 3: 293}
CELL_OPS_BY_MODEL = {0: 287, 1: 281, 2: 176, 3: 170}


def _check_scope(phys: Physics, cfg):
    """Raise ValueError outside the kernel's scope (pallas_residual
    use_march's conditions) and return the kernel's branch."""
    model = phys.turb_model
    nturb = 0 if model in ("none", "wale") else 2
    if (phys.ns != 1 or model not in MODELS or phys.neq != 5 + nturb
            or cfg.get("turb_model", model) != model
            or not cfg.get("viscous")
            or bool(cfg.get("turbulent")) != (model != "none")
            or cfg.get("block_matrix")
            or cfg.get("viscous_recon", "central") != "central"
            or phys.thermally_perfect):
        raise ValueError(
            "the viscous residual kernel covers one calorically perfect "
            "species, laminar, WALE, Wilcox 2006, SST 2003 and SST-DES (5 "
            "or 7 equations, viscous, central reconstruction, scalar "
            "solver) only")
    return MODELS[model]


def viscous_residual(phys: Physics, cfg, block, prim, t_all, mu_all):
    """Viscous residual of one block (see the module docstring).
    prim (neq, NI, NJ, NK) after the viscous ghost fill, t_all and mu_all
    (NI, NJ, NK)."""
    model = _check_scope(phys, cfg)
    if cfg.get("need_pgrad"):
        raise ValueError(
            "the viscous residual kernel forms no cell pressure gradient, "
            "which the nonreflecting (LODI) boundaries read: such a deck "
            "takes solver/viscous.viscous_residual, as in the JAX package")
    if vis.has_wall_law(block):
        raise ValueError(
            "the viscous residual kernel applies no wall-law face values: "
            "a block with a wallLaw viscousWall takes "
            "solver/viscous.viscous_residual, as in the JAX package")
    if prim.device.type == "cpu":
        return vis.viscous_residual(phys, cfg, block, prim, t_all, mu_all)
    if prim.device.type != "cuda":
        raise ValueError(f"no viscous residual for device {prim.device}")
    return _kernel(phys, cfg, block, prim, t_all, mu_all, model)


# ---------------------------------------------------------------------------
# CUDA kernel


def _load():
    from ..utils.build import load_cuda_library
    return load_cuda_library("viscous_march")


def _library():
    lib, _ = _load()
    fn = lib.viscous_march_f64
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 8 + [i] * 7 + [p, p]
        fn.restype = ctypes.c_int
    return fn


# the CUDA kernel's tiles: at most MAX_COLUMNS (j, k) columns (its
# THREADS take one face each of a 3 x 32 tile's step); segments of at
# most MAX_SEG planes; one CTA on each of an H100's SMS SMs at a time (its
# shared memory)
THREADS = 384
MAX_COLUMNS = 96
MAX_SEG = 32
SMS = 132
# a CTA's shared memory (csrc/viscous_march.cu smem_doubles): a ring of 3
# window planes of the equations, T and mu, the face records (REC_DOUBLES
# each by branch) and 21 staged statics of each face of a step, at most an
# H100 CTA's 232,448 bytes
REC_DOUBLES = {0: 24, 1: 22, 2: 14, 3: 13}
MAX_SMEM = 232448


def smem_bytes(model: int, tj: int, tk: int) -> int:
    """dynamic shared memory of one CTA of branch ``model`` with tj x tk
    columns"""
    neq = 7 if model < 2 else 5
    faces = 3 * tj * tk + tj + tk
    return 8 * (3 * (neq + 2) * (tj + 2) * (tk + 2)
                + REC_DOUBLES[model] * (faces + tj * tk) + 21 * faces)


def viscous_tile(dims):
    """(tj, tk, seg) of the CUDA kernel for a block of ``dims`` (ni, nj,
    nk) physical cells: a CTA owns tj x tk (j, k) columns (up to 32 along
    k, the contiguous axis of the face statics and the outputs, then up to
    MAX_COLUMNS in all, or 64 where tk <= 2) and marches over seg
    i-planes.  A CTA's time is about (seg + 1) steps, its first lower
    i-faces counting as one, and the CTAs run in waves of SMS: seg is the
    one of 1 .. MAX_SEG with the fewest waves x (seg + 1), the longest
    among equals.  3 x 32 x 22 at 256x64x32 (22 x 12 CTAs: 2 full waves),
    64 x 1 x 2 at 96x120x1."""
    ni, nj, nk = (int(n) for n in dims)
    tk = min(nk, 32)
    tj = min(nj, (MAX_COLUMNS if tk > 2 else 64) // tk)
    tiles = -(-nj // tj) * -(-nk // tk)
    seg = min(range(1, MAX_SEG + 1),
              key=lambda n: (-(-tiles * -(-ni // n) // SMS) * (n + 1), -n))
    return tj, tk, seg


def launch_info(block, model: str = "sst2003"):
    """What the kernel's launch for ``block`` takes on the current card:
    tile (tj, tk), seg, the CTAs of the launch, the dynamic shared memory
    of a CTA in bytes, the CTAs one SM holds, threads, registers and local
    (spill) bytes of a thread (csrc/viscous_march.cu viscous_march_info)."""
    tj, tk, seg = viscous_tile((block.ni, block.nj, block.nk))
    lib, _ = _load()
    fn = lib.viscous_march_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    got = (ctypes.c_int * 5)()
    err = fn(MODELS[model], tj, tk, ctypes.cast(got, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"viscous_march_info: CUDA error {err}")
    ctas = (-(-block.nj // tj) * -(-block.nk // tk)
            * -(-block.ni // seg))
    return dict(tile=(tj, tk), seg=seg, ctas=ctas, smem_bytes=got[0],
                ctas_per_sm=got[1], threads=got[2], registers=got[3],
                local_bytes=got[4])


def _params(phys: Physics, cfg) -> np.ndarray:
    """the kernel's parameters, in the order of its struct Params"""
    return np.array([
        phys.nondim_scaling, phys.R[0], phys.cp_s[0],
        phys.cp_s[0] / phys.cv_s[0], phys.cond_c1[0], phys.cond_s[0],
        phys.t_ref, phys.k_nondim,
        *phys.turb_min(), cfg["viscous_cfl_coeff"],
        SST["beta_star"], SST["sigma_k1"], SST["sigma_k2"], SST["sigma_w1"],
        SST["sigma_w2"], SST["a1"], phys.turb_prandtl(),
        WILCOX["sigma_star"], WILCOX["sigma"], WILCOX["clim"],
        WALE["cw"]], dtype=np.float64)


def _check(t, name, shape, device):
    if t.dtype != torch.float64 or t.device != device:
        raise ValueError(f"{name}: need float64 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def split_outputs(out):
    """(29 or 21, ni, nj, nk) kernel output -> the viscous_residual tuple
    (views)."""
    channels = out_channels(2 if out.shape[0] == 29 else 0)
    assert out.shape[0] == sum(k for _, k in channels), out.shape
    parts, c = {}, 0
    for name, k in channels:
        parts[name] = out[c:c + k] if k > 1 else out[c]
        c += k
    cellavg = {key: parts[key] for key in ("tke", "omega", "mut", "f1", "f2")
               if key in parts}
    cellavg["vel"] = parts["vel"].reshape((3, 3) + out.shape[1:])
    return (parts["resid"], parts["sr_flow"], parts["sr_turb"],
            parts["diag_flow"], parts["diag_turb"], cellavg)


def _kernel(phys: Physics, cfg, block, prim, t_all, mu_all, model: int):
    dev = prim.device
    ni, nj, nk, g = block.ni, block.nj, block.nk, block.g
    _check(prim, "prim", (phys.neq,) + block.shape, dev)
    _check(t_all, "t_all", block.shape, dev)
    _check(mu_all, "mu_all", block.shape, dev)
    with_len = vis.needs_face_length(cfg)
    statics = vis.viscous_statics(block, with_len)
    face = [statics["face"][d] for d in "ijk"]
    for a, arr in enumerate(face):
        fshape = [ni, nj, nk]
        fshape[a] += 1
        _check(arr, f"face statics {'ijk'[a]}",
               [vis.NFACE + int(with_len)] + fshape, dev)
    _check(statics["cell"], "cell statics", (4, ni, nj, nk), dev)
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
              if TIMINGS is not None else None)
    if events:
        events[0].record()
    out = torch.empty((sum(k for _, k in out_channels(phys.nturb)), ni, nj,
                       nk), dtype=torch.float64, device=dev)
    params = _params(phys, cfg)
    if events:
        events[1].record()
    err = _library()(model, prim.data_ptr(), t_all.data_ptr(),
                     mu_all.data_ptr(),
                     *(f.data_ptr() for f in face),
                     statics["cell"].data_ptr(), out.data_ptr(), ni, nj, nk,
                     g, *viscous_tile((ni, nj, nk)), params.ctypes.data,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"viscous_march_f64: CUDA error {err} at launch")
    LAUNCHES.count += 1
    if events:
        events[2].record()
        TIMINGS.append(events)
    return split_outputs(out)


def cost(block, model: str = "sst2003"):
    """(bytes, FP64 operations) of one residual of ``block`` with the
    turbulence model ``model``: each input (prim, T, mu, the face and cell
    statics the branch reads) read once, each output written once; the
    branch's operations per face and per cell.  Only the SST branch reads
    the faces' wall distance ('wdf'); only WALE the face length."""
    branch = MODELS[model]
    nturb = 2 if branch < 2 else 0
    ncell = block.ni * block.nj * block.nk
    npad = int(np.prod(block.shape))
    faces = sum(ncell + ncell // n for n in (block.ni, block.nj, block.nk))
    face_channels = vis.NFACE - int(branch != 0) + int(model == "wale")
    values = ((5 + nturb + 2) * npad
              + face_channels * faces
              + 4 * ncell
              + sum(k for _, k in out_channels(nturb)) * ncell)
    return 8 * values, (FACE_OPS_BY_MODEL[branch] * faces
                        + CELL_OPS_BY_MODEL[branch] * ncell)
