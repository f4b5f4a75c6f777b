"""ctypes binding of the k-d tree nearest-neighbour search that the
point-cloud initial conditions use (reference: src/kdtree.cpp).

``csrc/kdtree.cpp`` is a byte-identical copy of the JAX package's
``native/kdtree.cpp``, built with g++ at first use into
``aither_tpu_torch/build/`` (``utils/build.load_host_library``).  The
tree keeps the first point it visits at the least distance, which on a
tie is not always the lowest index, so a brute-force argmin would pick
other cells; there is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .build import load_host_library

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load_host_library("kdtree")
        lib.kdtree_build.restype = ctypes.c_void_p
        lib.kdtree_build.argtypes = [ctypes.POINTER(ctypes.c_double),
                                     ctypes.c_int64]
        lib.kdtree_free.argtypes = [ctypes.c_void_p]
        lib.kdtree_nearest.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
        _lib = lib
    return _lib


def nearest_neighbors(points: np.ndarray, queries: np.ndarray):
    """(indices, distances) of the nearest point for each query.

    points: (n, 3), queries: (m, 3), n > 0."""
    points = np.ascontiguousarray(points, dtype=np.float64)
    queries = np.ascontiguousarray(queries, dtype=np.float64)
    for name, arr in (("points", points), ("queries", queries)):
        if arr.ndim != 2 or arr.shape[1] != 3:
            raise ValueError(f"nearest_neighbors: {name} of shape "
                             f"{arr.shape}, not (n, 3)")
    if len(points) == 0:
        raise ValueError("nearest_neighbors: no points")
    lib = _load()
    dptr = ctypes.POINTER(ctypes.c_double)
    tree = lib.kdtree_build(points.ctypes.data_as(dptr), len(points))
    idx = np.empty(len(queries), dtype=np.int64)
    dist = np.empty(len(queries), dtype=np.float64)
    try:
        lib.kdtree_nearest(
            tree, queries.ctypes.data_as(dptr), len(queries),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dist.ctypes.data_as(dptr))
    finally:
        lib.kdtree_free(tree)
    return idx, dist
