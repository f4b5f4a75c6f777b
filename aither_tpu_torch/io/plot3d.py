"""Plot3D multi-block structured grid I/O.

Binary whole-format (no Fortran record markers), little-endian, matching the
reference reader (reference: src/plot3d.cpp:363-442): int32 block count,
int32 ni/nj/nk per block (node counts), then per block the x, y, z node
coordinates as float64 with i varying fastest.
"""

from __future__ import annotations

import numpy as np


def read_p3d(path: str, l_ref: float = 1.0) -> list[np.ndarray]:
    """Read a .xyz grid. Returns a list of (ni, nj, nk, 3) float64 node arrays
    (indexed [i, j, k, xyz]), scaled by 1/l_ref."""
    with open(path, "rb") as f:
        raw = f.read()
    off = 0
    nblks = int(np.frombuffer(raw, "<i4", 1, off)[0]); off += 4
    dims = []
    for _ in range(nblks):
        ni, nj, nk = np.frombuffer(raw, "<i4", 3, off); off += 12
        dims.append((int(ni), int(nj), int(nk)))
    blocks = []
    for ni, nj, nk in dims:
        n = ni * nj * nk
        coords = np.empty((ni, nj, nk, 3), dtype=np.float64)
        for d in range(3):
            v = np.frombuffer(raw, "<f8", n, off); off += 8 * n
            # file is i-fastest (Fortran order)
            coords[..., d] = v.reshape((nk, nj, ni)).transpose(2, 1, 0)
        blocks.append(coords / l_ref)
    return blocks


def write_p3d(path: str, blocks: list[np.ndarray]) -> None:
    """Write node arrays (ni, nj, nk, 3) to the same binary layout."""
    with open(path, "wb") as f:
        f.write(np.int32(len(blocks)).tobytes())
        for b in blocks:
            ni, nj, nk, _ = b.shape
            f.write(np.asarray([ni, nj, nk], dtype="<i4").tobytes())
        for b in blocks:
            for d in range(3):
                f.write(np.ascontiguousarray(
                    b[..., d].transpose(2, 1, 0), dtype="<f8").tobytes())
