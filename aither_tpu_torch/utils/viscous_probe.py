"""The fused viscous residual kernel (csrc/viscous_march.cu) of this
checkout beside another checkout's, on one GPU, in one call.

    python3 aither_tpu_torch/utils/viscous_probe.py [--against DIR]
                                                   [--phases]

For each checkout (DIR first, then this one, then DIR and this one again:
parent, change, parent, change) a process of its own imports that
checkout's ``aither_tpu_torch`` and ``chip_smoke.py``, builds the kernel
and the generated two-block SST lusgs plate of case B (2 x 256x64x32
cells), and on its seeded 1%-perturbed state (``chip_smoke.viscous_inputs``)
times the kernel on both blocks (CUDA events, one warm-up call, then
windows of ``chip_smoke.KERNEL_REPS`` calls), holds it to the plain version
(``chip_smoke``'s VISC_RTOL / VISC_ATOL measure) and saves one call's
outputs.  It prints, per process, one JSON line: the kernel's time per
window (after an untimed one), the ptxas registers and spills of every
instantiation, and where the checkout has ``viscous_march.launch_info``,
the launch's tile, segment, CTAs, shared memory and the CTAs per SM from
the CUDA occupancy API, else (the first design's 128-thread CTAs) the
CTAs an SM holds by the registers alone (the occupancy calculator's
rule).  Then
one JSON line comparing the checkouts' outputs: bit for bit, or the
largest difference.  With ``--phases``, this checkout's process also
builds the kernel's measurement variant (``-DVISCOUS_PHASE_CLOCKS``: one
thread of each CTA records clock64() at the marks the source lists) and
prints, for the last block's launch, the mean SM cycles of a CTA's
prologue, its first lower i-faces, a step's face phase and its combine,
the parts of one face and of one cell's combine.  Needs a card; DRAM
traffic and achieved occupancy need Nsight Compute, which this script does
not use.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DIMS = (256, 64, 32)  # case B (cases.SMOKE_3D_DIMS)
WINDOWS = 4
# an H100 SM: 64K registers in 256-register units of a warp, 64 warps
REGISTERS, WARPS = 65536, 64


def ctas_by_registers(registers: int, threads: int) -> int:
    """CTAs of ``threads`` threads that one SM holds by the registers (a
    warp's allocation rounded up to 256) and warps alone."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = -(-threads // 32)
    return min(REGISTERS // (per_warp * warps), WARPS // warps)


def phases(vm, phys, cfg, blocks, inputs) -> dict:
    """the measurement variant's clocks (see the module docstring)"""
    import numpy as np
    import torch
    from aither_tpu_torch.utils import build
    lib_path = os.path.join(build.BUILD_DIR, "libviscous_march_clocks.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                    "-DVISCOUS_PHASE_CLOCKS", "-o", lib_path,
                    os.path.join(build.CSRC_DIR, "viscous_march.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    saved, vm._load = vm._load, lambda: (lib, {})
    try:
        b = blocks[-1]
        vm.viscous_residual(phys, cfg, b, *inputs[b.index])
        torch.cuda.synchronize()
        tj, tk, seg = vm.viscous_tile((b.ni, b.nj, b.nk))
        ntiles = -(-b.nj // tj) * -(-b.nk // tk)
        ctas = min(ntiles * -(-b.ni // seg), 8192)
        clocks = (ctypes.c_longlong * (80 * ctas))()
        fn = lib.viscous_march_clocks
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if fn(ctypes.cast(clocks, ctypes.c_void_p), ctas) != 0:
            raise RuntimeError("viscous_march_clocks failed")
    finally:
        vm._load = saved
    C = np.frombuffer(clocks, dtype=np.int64).reshape(ctas, 80)
    planes = np.minimum(seg, b.ni - np.arange(ctas) // ntiles * seg)
    face, combine = [], []
    for n, npl in enumerate(planes):
        top = C[n, 2:2 + 2 * npl:2]
        mid = C[n, 3:3 + 2 * npl:2]
        face += list(mid - top)
        combine += list(np.append(top[1:], C[n, 66]) - mid)
    parts = np.diff(C[:, 67:74], axis=1).mean(axis=0)
    return dict(
        block=b.index, ctas=ctas, steps_per_cta=int(seg),
        cycles_cta=float((C[:, 66] - C[:, 0]).mean()),
        cycles_prologue=float((C[:, 1] - C[:, 0]).mean()),
        cycles_first_lower_faces=float((C[:, 2] - C[:, 1]).mean()),
        cycles_step_faces=float(np.mean(face)),
        cycles_step_combine=float(np.mean(combine)),
        cycles_face_parts=dict(zip(
            ("state", "gradients", "eddy_viscosity", "tau", "energy_flux",
             "area_fluxes"), map(float, parts))),
        cycles_combine_flow=float((C[:, 75] - C[:, 74]).mean()),
        cycles_combine_turbulence=float((C[:, 77] - C[:, 76]).mean()),
        sm_clock=subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


def worker(tree: str, tag: str, with_phases: bool) -> dict:
    """run in a process whose sys.path starts at ``tree``"""
    import numpy as np
    import torch
    import chip_smoke as cs
    from aither_tpu_torch.kernels import viscous_march as vm
    from aither_tpu_torch.solver import viscous as vis
    from aither_tpu_torch.utils.build import load_cuda_library
    assert vm.__file__.startswith(os.path.abspath(tree)), vm.__file__
    _, info = load_cuda_library("viscous_march")
    ptxas = cs.ptxas_report(info["ptxas"])
    wd = os.path.join(REPO, "smoke_run", f"probe_{tag}")
    solver = cs.make_solver(wd, DIMS, "cuda", "lusgs", 1, "sst")
    phys, cfg = solver.phys, solver.cfg
    inputs = cs.viscous_inputs(torch, solver)
    blocks = solver.case.blocks

    def run():
        return [vm.viscous_residual(phys, cfg, b, *inputs[b.index])
                for b in blocks]

    got = run()
    torch.cuda.synchronize()
    worst = 0.0
    for b, res in zip(blocks, got):
        want = cs.flat_outputs(vis.viscous_residual(phys, cfg, b,
                                                    *inputs[b.index]))
        for name, g in cs.flat_outputs(res).items():
            w = want[name]
            err = (g - w).abs()
            scale = float(w.abs().max())
            worst = max(worst, float((err / (
                cs.VISC_ATOL * scale + cs.VISC_RTOL * w.abs() + 1e-300)
                ).max()))
    torch.save([{k: v.cpu() for k, v in cs.flat_outputs(r).items()}
                for r in got], os.path.join(wd, "outputs.pt"))
    # an untimed window first: the plain run left the allocator's cache
    # without room for a window's outputs
    cs.timed_ms(torch, run, cs.KERNEL_REPS)
    windows = [cs.timed_ms(torch, run, cs.KERNEL_REPS)
               for _ in range(WINDOWS)]
    out = dict(tag=tag, tree=tree,
               card=cs.card_line(), windows_ms=windows,
               ms=float(np.mean(windows)), worst_vs_plain=worst,
               ptxas=ptxas, cost_bytes=sum(vm.cost(b)[0] for b in blocks))
    if hasattr(vm, "launch_info"):
        out["launch"] = [vm.launch_info(b) for b in blocks]
    else:
        # the first design: 128-thread CTAs, no shared memory
        out["ctas_per_sm_by_registers"] = [
            ctas_by_registers(int(x), 128) for ln in ptxas
            for x in [ln.split("Used ")[-1].split(" registers")[0]]]
    if with_phases:
        out["phases"] = phases(vm, phys, cfg, blocks, inputs)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="the other checkout's root")
    ap.add_argument("--phases", action="store_true",
                    help="also this checkout's phase clocks")
    ap.add_argument("--worker", nargs=2, metavar=("TREE", "TAG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(*args.worker, args.phases)), flush=True)
        return 0
    trees = [(REPO, "this")]
    if args.against:
        trees = [(os.path.abspath(args.against), "against")] + trees
        trees = trees * 2
    for n, (tree, tag) in enumerate(trees):
        tag = f"{tag}{n // 2}"
        phases_flag = (["--phases"] if args.phases and tree == REPO
                       and n < 2 else [])
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             tag, *phases_flag],
            capture_output=True, text=True, cwd=tree,
            env=dict(os.environ, PYTHONPATH=tree))
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return proc.returncode
    if args.against:
        import torch
        a, b = (torch.load(os.path.join(REPO, "smoke_run", f"probe_{t}",
                                        "outputs.pt"))
                for t in ("against0", "this0"))
        diff = {name: float((x[name] - y[name]).abs().max())
                for x, y in zip(a, b) for name in x}
        print(json.dumps(dict(
            bitwise=all(torch.equal(x[n], y[n])
                        for x, y in zip(a, b) for n in x),
            max_abs_diff=max(diff.values()),
            worst_output=max(diff, key=diff.get))), flush=True)
    return 0


if __name__ == "__main__":
    # run as a file: import the checkout's package and chip_smoke.py (the
    # worker's checkout, else this one), never this directory's modules
    sys.path[0] = (os.path.abspath(sys.argv[sys.argv.index("--worker") + 1])
                   if "--worker" in sys.argv else REPO)
    sys.exit(main())
