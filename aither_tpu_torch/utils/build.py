"""Build a CUDA source of this package into a shared library with nvcc at
first use, and load it with ctypes; a host C++ source likewise with g++
(``load_host_library``).

The library goes to ``aither_tpu_torch/build/`` (git-ignored), named by a
hash of the source, the ``csrc/*.cuh`` headers it includes and the flags,
so an edited source or shared header is rebuilt and an unchanged one is
reused within a checkout.  A library of ``VARIANTS`` is another build of
a source, with defines: the approximateRoe and the thermally perfect
forms of both sweeps are their own translation units, so that the
Rusanov ones build as they did and all of them build in parallel.  Usage::

    lib, info = load_cuda_library("lusgs_sweep")
    info["seconds"], info["ptxas"]      # build time, -Xptxas -v report
    load_cuda_libraries(["lusgs_sweep", "blusgs_sweep", "viscous_march"])
    # ^ one nvcc per library, all started together
    lib = load_host_library("kdtree")     # csrc/kdtree.cpp, g++
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library -> (source in csrc/ without ".cu", nvcc defines)
VARIANTS = {"lusgs_sweep_roe": ("lusgs_sweep", ("-DSWEEP_ROE=1",)),
            "blusgs_sweep_roe": ("blusgs_sweep", ("-DSWEEP_ROE=1",)),
            "lusgs_sweep_tp": ("lusgs_sweep", ("-DSWEEP_TP=1",)),
            "blusgs_sweep_tp": ("blusgs_sweep", ("-DSWEEP_TP=1",))}

# the flags of the JAX package's native/Makefile, for the host sources
GXX_FLAGS = ("-O3", "-march=native", "-std=c++14", "-fPIC", "-fopenmp",
             "-shared")

_LOADED: dict = {}


def nvcc_path() -> str:
    """nvcc from PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def local_headers(path: str) -> list:
    """the ``csrc`` headers ``path`` includes with ``#include "..."``,
    directly or through another of them, sorted"""
    found, todo = set(), [path]
    while todo:
        with open(todo.pop()) as f:
            names = re.findall(r'(?m)^\s*#\s*include\s+"([^"]+)"', f.read())
        for name in names:
            header = os.path.join(CSRC_DIR, name)
            if header not in found and os.path.isfile(header):
                found.add(header)
                todo.append(header)
    return sorted(found)


def _paths(name: str, ext: str = ".cu", base_flags=NVCC_FLAGS):
    """(source, library path, compiler flags) of library ``name``: built
    from ``csrc/<name><ext>``, or from the source ``VARIANTS`` names with
    its defines; the library's name hashes the source, its local headers
    and the flags"""
    source, defines = VARIANTS.get(name, (name, ()))
    src = os.path.join(CSRC_DIR, f"{source}{ext}")
    flags = (*base_flags, *defines)
    digest = hashlib.sha256()
    for path in [src] + local_headers(src):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}_{digest.hexdigest()[:16]}.so"), flags


def load_cuda_libraries(names):
    """{name: (ctypes.CDLL, info)} for the library of every name.
    The libraries not built yet are compiled by one nvcc each, all started
    together.  ``info`` has the library path, whether it was built in this
    call, the build seconds and the compiler's ``-Xptxas -v`` lines."""
    infos = {}
    for name in names:
        if name not in _LOADED:
            src, lib_path, flags = _paths(name)
            infos[name] = dict(src=src, path=lib_path, flags=flags,
                               built=False, seconds=0.0, ptxas="")
    missing = [n for n, i in infos.items() if not os.path.isfile(i["path"])]
    if missing:
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        builds = {}
        for name in missing:
            tmp = f"{infos[name]['path']}.{os.getpid()}.tmp"
            cmd = [nvcc, *infos[name]["flags"], "-o", tmp,
                   infos[name]["src"]]
            builds[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE,
                                             text=True),
                            cmd, tmp, time.perf_counter())
        failed = []
        for name, (proc, cmd, tmp, t0) in builds.items():
            out, err = proc.communicate()
            info = infos[name]
            info["seconds"] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}\n{err}")
                continue
            os.replace(tmp, info["path"])
            info["built"] = True
            info["ptxas"] = "\n".join(
                ln for ln in (out + err).splitlines()
                if "ptxas" in ln or "spill" in ln)
        if failed:
            raise RuntimeError("\n".join(failed))
    for name, info in infos.items():
        _LOADED[name] = (ctypes.CDLL(info["path"]), info)
    return {name: _LOADED[name] for name in names}


def load_cuda_library(name: str):
    """(ctypes.CDLL, info) for the library ``name``, building it if needed
    (see ``load_cuda_libraries``)."""
    return load_cuda_libraries([name])[name]


def load_host_library(name: str):
    """ctypes.CDLL of the host C++ source ``csrc/<name>.cpp``, built with
    g++ and ``GXX_FLAGS`` at first use into ``BUILD_DIR``.  A failed build
    raises with the compiler's message."""
    key = ("host", name)
    if key not in _LOADED:
        src, lib_path, flags = _paths(name, ".cpp", GXX_FLAGS)
        if not os.path.isfile(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = ["g++", *flags, "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}\n"
                                   f"{proc.stderr}")
            os.replace(tmp, lib_path)
        _LOADED[key] = ctypes.CDLL(lib_path)
    return _LOADED[key]
