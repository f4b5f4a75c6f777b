"""Build a CUDA source of this package into a shared library with nvcc at
first use, and load it with ctypes; a host C++ source likewise with g++
(``load_host_library``).

The library goes to ``aither_tpu_torch/build/`` (git-ignored), named by a
hash of the source, the ``csrc/*.cuh`` headers it includes and the flags,
so an edited source or shared header is rebuilt and an unchanged one is
reused within a checkout.  A sweep library's name says which build of
its source it is (``library_source``): ``<source>[_roe][_tp][_ns<N>]``,
the approximateRoe (``-DSWEEP_ROE=1``) and thermally perfect
(``-DSWEEP_TP=1``) forms of both sweeps, and a species count N above the
base build's ``SWEEP_BASE_NS`` (``-DSWEEP_NS=N``: that count alone, built
when a deck first needs it), each its own translation unit, so that the
Rusanov forms of 1-5 species build as they did and all of them build in
parallel; ``<name>_probe`` is any sweep library with its step clocks'
marks (``-DSWEEP_PROBE=1``, for ``utils/sweep_probe.py``).
Usage::

    lib, info = load_cuda_library("lusgs_sweep")
    info["seconds"], info["ptxas"]      # build time, -Xptxas -v report
    load_cuda_libraries(["lusgs_sweep", "blusgs_sweep", "viscous_march"])
    # ^ one nvcc per library, all started together
    load_cuda_library("blusgs_sweep_roe_tp_ns7")
    # ^ csrc/blusgs_sweep.cu, -DSWEEP_ROE=1 -DSWEEP_TP=1 -DSWEEP_NS=7
    lib = load_host_library("kdtree")     # csrc/kdtree.cpp, g++
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# species counts of a sweep library without an _ns<N> suffix (BASE_NS of
# csrc/lusgs_sweep.cu and csrc/blusgs_sweep.cu)
SWEEP_BASE_NS = 5
_SWEEP_LIBRARY = re.compile(
    r"(lusgs_sweep|blusgs_sweep)(_roe)?(_tp)?(?:_ns([1-9][0-9]*))?"
    r"(_probe)?")

# the flags of the JAX package's native/Makefile, for the host sources
GXX_FLAGS = ("-O3", "-march=native", "-std=c++14", "-fPIC", "-fopenmp",
             "-shared")

_LOADED: dict = {}
_BUILD_LOCK = threading.Lock()


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


def library_source(name: str):
    """(source in ``csrc/`` without its extension, compiler defines) of
    library ``name``: a sweep library ``<source>[_roe][_tp][_ns<N>]`` is
    its source with ``-DSWEEP_ROE=1``, ``-DSWEEP_TP=1`` and
    ``-DSWEEP_NS=N`` for its suffixes (N above ``SWEEP_BASE_NS``: the
    base build holds 1 to SWEEP_BASE_NS species), and ``..._probe`` with
    the step clocks' marks (``-DSWEEP_PROBE=1``, for
    ``utils/sweep_probe.py``); any other name is its own source without
    defines"""
    m = _SWEEP_LIBRARY.fullmatch(name)
    if m is None:
        return name, ()
    source, roe, tp, ns, probe = m.groups()
    defines = (("-DSWEEP_ROE=1",) if roe else ()) + (
        ("-DSWEEP_TP=1",) if tp else ())
    if ns is not None:
        if int(ns) <= SWEEP_BASE_NS:
            raise ValueError(f"{name}: the base build holds 1-"
                             f"{SWEEP_BASE_NS} species; an _ns<N> library "
                             f"is of a count above it")
        defines += (f"-DSWEEP_NS={int(ns)}",)
    if probe:
        defines += ("-DSWEEP_PROBE=1",)
    return source, defines


def _paths(name: str, ext: str = ".cu", base_flags=NVCC_FLAGS):
    """(source, library path, compiler flags) of library ``name``: built
    from the source and defines of ``library_source``; the library's name
    hashes the source, its local headers and the flags"""
    source, defines = library_source(name)
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
    call, the build seconds (from the start of its nvcc to its library
    file's last write) and the compiler's ``-Xptxas -v`` lines.  Builds
    hold a lock, so that a thread may build libraries behind other work:
    a call that needs a library being built waits for it; a call for
    libraries already loaded does not wait."""
    if all(name in _LOADED for name in names):
        return {name: _LOADED[name] for name in names}
    with _BUILD_LOCK:
        infos = {}
        for name in names:
            if name not in _LOADED:
                src, lib_path, flags = _paths(name)
                infos[name] = dict(src=src, path=lib_path, flags=flags,
                                   built=False, seconds=0.0, ptxas="")
        missing = [n for n, i in infos.items()
                   if not os.path.isfile(i["path"])]
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
                                cmd, tmp, time.time())
            failed = []
            for name, (proc, cmd, tmp, started) in builds.items():
                out, err = proc.communicate()
                info = infos[name]
                if proc.returncode != 0:
                    failed.append(f"nvcc failed ({proc.returncode}):\n"
                                  f"{' '.join(cmd)}\n{out}\n{err}")
                    continue
                info["seconds"] = os.path.getmtime(tmp) - started
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
