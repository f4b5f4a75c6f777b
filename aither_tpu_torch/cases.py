"""Generated main-path case: a two-block flat plate, SST k-omega by default.

The headline deck of the JAX package is RAE2822 (implicit RANS, SST 2003,
scalar LU-SGS with one sweep, Rusanov off-diagonal, Roe + MUSCL, a C-grid
wake cut that is an interblock connection).  Its grid is not part of the
repository, so this module writes a Plot3D grid and a deck with the same
physics and solver settings on a generated topology:

* two blocks joined end to end in i by an ``interblock`` connection,
* characteristic far field at block 0's i-min, block 1's i-max and j-max,
* an isothermal ``viscousWall`` at j-min (tanh-clustered toward it),
* ``slipWall`` on the k faces.

Interblock tags encode the partner as ``partnerSurface*1000 +
partnerBlock`` with surfaces numbered 1-6 = i-lo, i-hi, j-lo, j-hi, k-lo,
k-hi, so block 0's i-hi patch names surface 1 of block 1 (``1001``) and
block 1's i-lo patch names surface 2 of block 0 (``2000``).

``equation_set`` and ``turbulence_model`` select the other physics the
port runs (euler, navierStokes, largeEddySimulation + wale, rans +
kOmegaWilcox2006 / sst2003 / sstdes).  Without turbulence equations the
states carry no turbulence entries; for ``euler`` the j-min patches are
``slipWall`` and the ``viscousWall`` boundary state goes.

Usage::

    from aither_tpu_torch.cases import write_plate_case
    deck_path = write_plate_case(out_dir, ni=96, nj=120, nk=1)
"""

from __future__ import annotations

import os

import numpy as np

from .io.plot3d import write_p3d

# sizes used by the tests and by chip_smoke.py: (ni, nj, nk) of EACH block
TEST_DIMS = (12, 8, 3)
SMOKE_2D_DIMS = (96, 120, 1)      # 2 x 11,520 = 23,040 cells (rae2822 size)
SMOKE_3D_DIMS = (256, 64, 32)     # 2 x 524,288 = 1,048,576 cells

PLATE_LENGTH = 1.0     # m, both blocks together
PLATE_HEIGHT = 0.05    # m, wall to far field
PLATE_WIDTH = 0.05     # m, spanwise extent
CLUSTER = 3.0          # tanh clustering strength toward the wall

_DECK = """\
gridName: {grid}
iterations: {iterations}
outputFrequency: 1000
referenceDensity: 1.2256
referenceTemperature: 288.0
referenceLength: 1.0
equationSet: {equation_set}
turbulenceModel: {turbulence_model}
timeIntegration: implicitEuler
matrixSolver: {matrix_solver}
matrixSweeps: {matrix_sweeps}
matrixRelaxation: 1.0
inviscidFlux: roe
inviscidFluxJacobian: rusanov
faceReconstruction: thirdOrder
limiter: vanAlbada
viscousFaceReconstruction: central
cflStart: 10.0
cflStep: 10.0
cflMax: 1000.0
fluids: <fluid(name=air; referenceMassFraction=1.0)>
initialConditions: <icState(tag=-1; pressure=101300.0; density=1.2256; velocity=[68.0, 0.0, 0.0]{turb})>
boundaryStates: <characteristic(tag=1; pressure=101300.0; density=1.2256; velocity=[68.0, 0.0, 0.0]{turb}){wall_state}>
boundaryConditions: 2
2 2 2
  characteristic  0 0 0 {nj} 0 {nk} 1
  interblock  {ni} {ni} 0 {nj} 0 {nk} 1001
  {wall}
  characteristic  0 {ni} {nj} {nj} 0 {nk} 1
  slipWall  0 {ni} 0 {nj} 0 0 0
  slipWall  0 {ni} 0 {nj} {nk} {nk} 0
2 2 2
  interblock  0 0 0 {nj} 0 {nk} 2000
  characteristic  {ni} {ni} 0 {nj} 0 {nk} 1
  {wall}
  characteristic  0 {ni} {nj} {nj} 0 {nk} 1
  slipWall  0 {ni} 0 {nj} 0 0 0
  slipWall  0 {ni} 0 {nj} {nk} {nk} 0
"""


def plate_nodes(ni: int, nj: int, nk: int) -> list[np.ndarray]:
    """Node coordinates (ni+1, nj+1, nk+1, 3) of the two blocks."""
    half = 0.5 * PLATE_LENGTH
    eta = np.arange(nj + 1) / nj
    y = PLATE_HEIGHT * (1.0 - np.tanh(CLUSTER * (1.0 - eta))
                        / np.tanh(CLUSTER))
    z = PLATE_WIDTH * np.arange(nk + 1) / nk
    blocks = []
    for b in range(2):
        x = half * (b + np.arange(ni + 1) / ni)
        xx, yy, zz = np.meshgrid(x, y, z, indexing="ij")
        blocks.append(np.stack([xx, yy, zz], axis=-1))
    return blocks


def write_plate_case(out_dir: str, ni: int, nj: int, nk: int,
                     iterations: int = 10, name: str = "plate",
                     matrix_sweeps: int = 1,
                     matrix_solver: str = "lusgs",
                     equation_set: str = "rans",
                     turbulence_model: str = "sst2003") -> str:
    """Write ``<name>.xyz`` and ``<name>.inp`` into ``out_dir``; returns
    the deck path.  ``matrix_sweeps`` > 1 gives the lagged-term LU-SGS;
    ``matrix_solver`` "blusgs" the block-matrix LU-SGS; ``equation_set``
    and ``turbulence_model`` the physics (module docstring)."""
    turb = ("; turbulenceIntensity=0.01; eddyViscosityRatio=10.0"
            if equation_set == "rans" else "")
    inviscid = equation_set == "euler"
    wall = (f"slipWall  0 {ni} 0 0 0 {nk} 0" if inviscid
            else f"viscousWall  0 {ni} 0 0 0 {nk} 2")
    wall_state = "" if inviscid else ", viscousWall(tag=2; temperature=288.0)"
    os.makedirs(out_dir, exist_ok=True)
    write_p3d(os.path.join(out_dir, f"{name}.xyz"), plate_nodes(ni, nj, nk))
    deck_path = os.path.join(out_dir, f"{name}.inp")
    with open(deck_path, "w") as f:
        f.write(_DECK.format(grid=name, iterations=iterations, ni=ni, nj=nj,
                             nk=nk, matrix_sweeps=matrix_sweeps,
                             matrix_solver=matrix_solver,
                             equation_set=equation_set,
                             turbulence_model=turbulence_model, turb=turb,
                             wall=wall, wall_state=wall_state))
    return deck_path
