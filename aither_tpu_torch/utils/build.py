"""Build a CUDA source of this package into a shared library with nvcc at
first use, and load it with ctypes.

The library goes to ``aither_tpu_torch/build/`` (git-ignored), named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused within a checkout.  Usage::

    lib, info = load_cuda_library("lusgs_sweep")
    info["seconds"], info["ptxas"]      # build time, -Xptxas -v report
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def load_cuda_library(name: str):
    """(ctypes.CDLL, info) for ``csrc/<name>.cu``, building it if needed.
    ``info`` has the library path, whether it was built in this call, the
    build seconds and the compiler's ``-Xptxas -v`` lines."""
    if name in _LOADED:
        return _LOADED[name]
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR,
                            f"lib{name}_{digest.hexdigest()[:16]}.so")
    info = dict(path=lib_path, built=False, seconds=0.0, ptxas="")
    if not os.path.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
        info["built"] = True
        info["ptxas"] = "\n".join(
            ln for ln in (proc.stdout + proc.stderr).splitlines()
            if "ptxas" in ln or "spill" in ln)
    _LOADED[name] = (ctypes.CDLL(lib_path), info)
    return _LOADED[name]
