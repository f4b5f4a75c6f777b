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

``time_integration``, ``time_step`` (s), ``nonlinear_iterations`` and
``dual_time_cfl`` set the time integrator (implicitEuler by default;
crankNicholson, bdf2, explicitEuler, rk4), ``matrix_solver`` and
``inviscid_flux_jacobian`` the linear solver (lusgs, blusgs, dplur,
bdplur; rusanov or approximateRoe), ``cfl`` the ramp (start, step,
max) and ``multigrid_levels`` / ``multigrid_cycle`` the FAS multigrid
(V or W cycles); the defaults write the implicit Euler deck of the main
path on one grid level.
``equation_set`` and ``turbulence_model`` select the other physics the
port runs (euler, navierStokes, largeEddySimulation + wale, rans +
kOmegaWilcox2006 / sst2003 / sstdes).  Without turbulence equations the
states carry no turbulence entries; for ``euler`` the j-min patches are
``slipWall`` and the ``viscousWall`` boundary state goes.

``output_frequency``, ``restart_frequency``, ``output_variables``,
``wall_output_variables`` and ``output_nodal`` set the function and
restart files (``Solver.run(write_files=True)``, the CLI without
``--no-files``); ``ic_file`` replaces the uniform initial state by a
point-cloud file (``icState(file=...)``), such as ``write_cloud`` writes.

``species`` and ``mass_fractions`` make the gas a calorically perfect
mixture (the ``fluids`` list, ``massFractions`` on every state),
``diffusion`` sets ``diffusionModel`` and ``chemistry`` names a mechanism
of ``MECHANISMS``: the deck reacts (``chemistryModel: reacting``) and the
mechanism's text is written beside it as ``<out_dir>/<chemistry>.mch``.
``N2O2`` and ``AIR5`` are the two mixtures the tests and the smoke run
use: nitrogen/oxygen air at the plate's 288 K, and five-species air
(N2, O2, NO, N, O) at about 3,900 K with a wall at 3,500 K, hot enough
for the mechanism's dissociation to move the residual.  ``MIXTURES``
names them with the frozen (non-reacting) forms of hot air in five, four
and three species, frozen burned hydrogen-air in seven and a frozen
mixture of every species of the fluid database and a tracer (16), which
give the sweep kernels' base libraries every count they hold and two
counts of libraries of their own.  A species of ``TRACERS`` is another
species' properties under a name of its own, with vibrational modes added
to its own: its fluid file is written beside the deck
(``<out_dir>/<name>.dat``) and read from the working directory, as
``load_fluid`` reads any species file.  ``n2o2_ch4x`` is N2/O2 with 4% of
the tracer ``CH4x``, methane's nine modes and two more: a species of
eleven modes, more than any of the fluid database, for a thermally
perfect deck.

Usage::

    from aither_tpu_torch.cases import write_plate_case
    deck_path = write_plate_case(out_dir, ni=96, nj=120, nk=1)
"""

from __future__ import annotations

import os

import numpy as np

from .io.plot3d import write_p3d
from .physics.fluid import load_fluid

# sizes used by the tests and by chip_smoke.py: (ni, nj, nk) of EACH block
TEST_DIMS = (12, 8, 3)
SMOKE_2D_DIMS = (96, 120, 1)      # 2 x 11,520 = 23,040 cells (rae2822 size)
SMOKE_3D_DIMS = (256, 64, 32)     # 2 x 524,288 = 1,048,576 cells

PLATE_LENGTH = 1.0     # m, both blocks together
PLATE_HEIGHT = 0.05    # m, wall to far field
PLATE_WIDTH = 0.05     # m, spanwise extent
CLUSTER = 3.0          # tanh clustering strength toward the wall
# the clustering of a wall-law deck on the smoke cases (nj = 64 and 120):
# its first cells sit at y+ of about 66 (case B) and 39 (case A) at the
# plate's freestream, where CLUSTER puts them below 10.  The JAX package's
# wall law brackets y+ in [10, 1e4] and sets an unbracketed face to 1e4
# (it never takes its y+ < 10 low-Re switch), and its run then turns to
# NaN; at TEST_DIMS (nj = 8) CLUSTER gives y+ of about 45.
WALL_LAW_CLUSTER = 1.0

_DECK = """\
gridName: {grid}
iterations: {iterations}
outputFrequency: {output_frequency}
{output_lines}referenceDensity: 1.2256
referenceTemperature: 288.0
referenceLength: 1.0
{mixture}equationSet: {equation_set}
turbulenceModel: {turbulence_model}
timeIntegration: {time_integration}
{time_lines}matrixSolver: {matrix_solver}
matrixSweeps: {matrix_sweeps}
{mg_lines}matrixRelaxation: 1.0
inviscidFlux: {inviscid_flux}
inviscidFluxJacobian: {inviscid_flux_jacobian}
faceReconstruction: {face_reconstruction}
limiter: vanAlbada
viscousFaceReconstruction: {viscous_face_reconstruction}
{thermo_lines}cflStart: {cfl[0]}
cflStep: {cfl[1]}
cflMax: {cfl[2]}
fluids: <{fluids}>
initialConditions: <icState(tag=-1; {ic})>
boundaryStates: <characteristic(tag=1; pressure=101300.0; density={density}; velocity=[{velocity}, 0.0, 0.0]{turb}{mf}){wall_state}{states}>
boundaryConditions: 2
2 2 2
  {inflow}  0 0 0 {nj} 0 {nk} {inflow_tag}
  interblock  {ni} {ni} 0 {nj} 0 {nk} 1001
  {wall}
  characteristic  0 {ni} {nj} {nj} 0 {nk} 1
  {span}  0 {ni} 0 {nj} 0 0 {span_tags[0]}
  {span}  0 {ni} 0 {nj} {nk} {nk} {span_tags[1]}
2 2 2
  interblock  0 0 0 {nj} 0 {nk} 2000
  {outflow}  {ni} {ni} 0 {nj} 0 {nk} {outflow_tag}
  {wall}
  characteristic  0 {ni} {nj} {nj} 0 {nk} 1
  {span}  0 {ni} 0 {nj} 0 0 {span_tags[0]}
  {span}  0 {ni} 0 {nj} {nk} {nk} {span_tags[1]}
"""


# Arrhenius forward rates (SI: m^3/mol/s, K) of three dissociation and
# exchange reactions of five-species air after Park; N2 is the collision
# partner.  Backward rates follow from the Gibbs equilibrium constant.
MECHANISMS = {
    "air5": """\
# five-species air, three reactions
O2 + N2 <=> 2 O + N2 : forwardRate=arrhenius(C=2.0e15, eta=-1.5, theta=59500.0)
NO + N2 <=> N + O + N2 : forwardRate=arrhenius(C=5.0e9, eta=0.0, theta=75500.0)
N2 + O <=> NO + N : forwardRate=arrhenius(C=6.4e11, eta=-1.0, theta=38400.0)
""",
}

# the time integrators' decks on the plate (write_plate_case keywords): the
# explicit ones are stable there at a CFL of about 0.5 (the implicit ramp
# 10-1000 diverges); bdf2 takes a global step of 1e-5 s (0.0034 at the
# reference speed of sound and length) and three dual-time iterations a
# step at dual-time CFL 100
EXPLICIT_CFL = (0.5, 0.0, 0.5)
TIME_INTEGRATORS = {
    "implicitEuler": {},
    "crankNicholson": dict(time_integration="crankNicholson"),
    "bdf2": dict(time_integration="bdf2", time_step=1e-5,
                 nonlinear_iterations=3, dual_time_cfl=100.0),
    "explicitEuler": dict(time_integration="explicitEuler",
                          cfl=EXPLICIT_CFL),
    "rk4": dict(time_integration="rk4", nonlinear_iterations=4,
                cfl=EXPLICIT_CFL),
}

# the function-file variables of the files tests and of chip_smoke.py's
# phase 14: the state, every gradient family, the residuals, dt, the eddy
# viscosity and the wall distance (every aux branch of
# Solver.write_output), and the wall variables
FILES_OUTPUT_VARIABLES = (
    "density", "vel_x", "vel_y", "vel_z", "pressure", "temperature",
    "viscosity", "mach", "tke", "sdr", "velGrad_uy", "tempGrad_y",
    "densityGrad_y", "pressGrad_x", "tkeGrad_y", "omegaGrad_y",
    "resid_mass", "resid_sdr", "dt", "turbulentViscosity", "viscosityRatio",
    "wallDistance", "f1")
FILES_WALL_VARIABLES = ("yplus", "shearStress", "heatFlux")

N2O2 = dict(species=("N2", "O2"), mass_fractions=(0.767, 0.233),
            diffusion="schmidt")
AIR5 = dict(species=("N2", "O2", "NO", "N", "O"),
            mass_fractions=(0.74, 0.2, 0.03, 0.01, 0.02),
            diffusion="schmidt", chemistry="air5", density=0.0882,
            wall_temperature=3500.0)
# by name, with the frozen twin of hot air (no chemistry) and its frozen
# three- and four-species subsets
MIXTURES = {"n2o2": N2O2, "air5": AIR5,
            "air5_frozen": dict(AIR5, chemistry=None),
            "air3_frozen": dict(AIR5, chemistry=None,
                                species=("N2", "O2", "NO"),
                                mass_fractions=(0.75, 0.2, 0.05)),
            "air4_frozen": dict(AIR5, chemistry=None,
                                species=("N2", "O2", "NO", "O"),
                                mass_fractions=(0.74, 0.2, 0.04, 0.02))}
# the species of the seven-species hydrogen-air mechanisms, frozen, at the
# mass fractions of lean (equivalence ratio 0.5) hydrogen-air burned to
# H2O with traces of the radicals (about 3,560 K at hot air's density)
MIXTURES["h2air7_frozen"] = dict(
    AIR5, chemistry=None, species=("H2", "O2", "H2O", "OH", "H", "O", "N2"),
    mass_fractions=(0.001, 0.112, 0.126, 0.004, 0.0005, 0.0015, 0.755))
# the tracers (module docstring): name -> (the species whose properties it
# takes, vibrational temperatures in K added to that species' own)
TRACERS = {"N2t": ("N2", ()), "CH4x": ("CH4", (950.0, 3800.0))}
# the species of the fluid database (physics/fluid.py)
DATABASE_SPECIES = ("air", "Ar", "CH4", "CO", "CO2", "H", "H2", "H2O", "He",
                    "N", "N2", "NO", "O", "O2", "OH")
# every species of the fluid database and the tracer, in equal parts
# (about 960 K at hot air's density): the top count a deck of the plate
# names, a test of the kernels' widest forms rather than a physical gas
MIXTURES["db16_frozen"] = dict(
    AIR5, chemistry=None, wall_temperature=1000.0,
    species=DATABASE_SPECIES + ("N2t",),
    mass_fractions=(0.0625,) * 16)
# N2/O2 with a species of eleven vibrational modes (module docstring)
MIXTURES["n2o2_ch4x"] = dict(N2O2, species=("N2", "O2", "CH4x"),
                             mass_fractions=(0.74, 0.22, 0.04))
# hot one-species air for a thermally perfect deck (write_plate_case
# keywords): about 4,000 K at 101300 Pa, a wall at 3,500 K.  Air's
# vibrational temperature is 3,056 K (physics/fluid.py), so the
# vibrational terms are a few percent of the energy here, where at the
# plate's 288 K they are about 1e-5 of it
TP_AIR = dict(density=0.0882, wall_temperature=3500.0,
              thermodynamic_model="thermallyPerfect")


def species_file_text(name: str, modes=()) -> str:
    """the fluid file (``<species>.dat``, the format ``load_fluid``
    reads) of species ``name``'s properties, with the vibrational
    temperatures ``modes`` (K) after its own"""
    f = load_fluid(name)
    vib = ", ".join(repr(t) for t in (*f.vib_temps, *modes))
    return (f"n: {f.n!r}\nmolarMass: {1000.0 * f.molar_mass!r}\n"
            f"vibrationalTemperature: [{vib}]\n"
            f"heatOfFormation: {f.heat_of_formation!r}\n"
            f"referencePressure: {f.ref_p!r}\n"
            f"referenceTemperature: {f.ref_t!r}\n"
            f"referenceEntropy: {f.ref_s!r}\n"
            f"sutherlandViscosityC1: {f.visc_c1!r}\n"
            f"sutherlandViscosityS: {f.visc_s!r}\n"
            f"sutherlandConductivityC1: {f.cond_c1!r}\n"
            f"sutherlandConductivityS: {f.cond_s!r}\n")


def plate_nodes(ni: int, nj: int, nk: int,
                cluster: float = CLUSTER) -> list[np.ndarray]:
    """Node coordinates (ni+1, nj+1, nk+1, 3) of the two blocks, with the
    tanh clustering strength ``cluster`` toward the wall."""
    half = 0.5 * PLATE_LENGTH
    eta = np.arange(nj + 1) / nj
    y = PLATE_HEIGHT * (1.0 - np.tanh(cluster * (1.0 - eta))
                        / np.tanh(cluster))
    z = PLATE_WIDTH * np.arange(nk + 1) / nk
    blocks = []
    for b in range(2):
        x = half * (b + np.arange(ni + 1) / ni)
        xx, yy, zz = np.meshgrid(x, y, z, indexing="ij")
        blocks.append(np.stack([xx, yy, zz], axis=-1))
    return blocks


def stagnation_state(density: float, velocity: float, species=None,
                     mass_fractions=None):
    """(p0 in Pa, T0 in K) of the plate's freestream (101300 Pa,
    ``density``, ``velocity`` along x) for the calorically perfect gas of
    the deck: air, or the mixture of ``species``"""
    fluids = [load_fluid(TRACERS[name][0] if name in TRACERS else name)
              for name in species or ("air",)]
    mfs = mass_fractions or (1.0,)
    r = sum(m * f.gas_constant for f, m in zip(fluids, mfs))
    cv = sum(m * f.n * f.gas_constant for f, m in zip(fluids, mfs))
    gamma = (cv + r) / cv
    t = 101300.0 / (density * r)
    t0 = t + 0.5 * velocity * velocity / (cv + r)
    return 101300.0 * (t0 / t) ** (gamma / (gamma - 1.0)), t0


def write_plate_case(out_dir: str, ni: int, nj: int, nk: int,
                     iterations: int = 10, name: str = "plate",
                     matrix_sweeps: int = 1,
                     matrix_solver: str = "lusgs",
                     equation_set: str = "rans",
                     turbulence_model: str = "sst2003",
                     species=None, mass_fractions=None,
                     diffusion: str = "none", chemistry=None,
                     density: float = 1.2256,
                     wall_temperature: float = 288.0,
                     time_integration: str = "implicitEuler",
                     inviscid_flux_jacobian: str = "rusanov",
                     time_step: float = 0.0,
                     nonlinear_iterations: int = 1,
                     dual_time_cfl: float = -1.0,
                     cfl=(10.0, 10.0, 1000.0),
                     multigrid_levels: int = 1,
                     multigrid_cycle: str = "V",
                     inflow: str = "characteristic",
                     outflow: str = "characteristic",
                     nonreflecting: bool = False,
                     wall_treatment: str = "lowRe",
                     span: str = "slipWall",
                     velocity: float = 68.0,
                     cluster: float = CLUSTER,
                     output_frequency: int = 1000,
                     restart_frequency: int = 0,
                     output_variables=None,
                     wall_output_variables=None,
                     output_nodal: bool = False,
                     ic_file=None,
                     face_reconstruction: str = "thirdOrder",
                     viscous_face_reconstruction: str = "central",
                     inviscid_flux: str = "roe",
                     thermodynamic_model: str = "caloricallyPerfect") -> str:
    """Write ``<name>.xyz`` and ``<name>.inp`` into ``out_dir``; returns
    the deck path.  ``matrix_sweeps`` > 1 gives the lagged-term LU-SGS;
    ``matrix_solver`` "blusgs" the block-matrix LU-SGS, "dplur" / "bdplur"
    the scalar / block DPLUR; ``inviscid_flux_jacobian`` the off-diagonal
    (rusanov, approximateRoe); ``time_integration`` the integrator,
    ``time_step`` its global step in seconds (0: local time stepping),
    ``nonlinear_iterations`` the (dual-time) iterations of a step,
    ``dual_time_cfl`` the dual-time CFL (off when not positive; the three
    lines are written only when they differ from the deck's defaults);
    ``cfl`` the ramp (cflStart, cflStep, cflMax); ``multigrid_levels``
    and ``multigrid_cycle`` (V, W) the FAS multigrid of the linear solve
    (both lines written only when they differ from the deck's defaults,
    1 and V); ``equation_set``
    and ``turbulence_model`` the physics; ``species``, ``mass_fractions``,
    ``diffusion`` and ``chemistry`` the mixture (module docstring);
    ``density`` (kg/m^3, at 101300 Pa) and ``velocity`` (m/s, along x)
    the state and ``wall_temperature`` (K) the isothermal wall.

    The boundaries: ``inflow`` (block 0's i-min: characteristic, inlet,
    stagnationInlet at the freestream's p0 and T0 along x, or
    supersonicInflow), ``outflow`` (block 1's i-max: characteristic,
    pressureOutlet at 101300 Pa, or supersonicOutflow), ``nonreflecting``
    (the LODI forms of inlet and pressureOutlet, lengthScale the plate's
    length), ``wall_treatment`` (lowRe or wallLaw) and ``span`` (the k
    faces: slipWall, or periodic with the translation [0, 0,
    PLATE_WIDTH]); ``cluster`` the grid's tanh clustering toward the
    wall (a wall-law deck on a fine grid takes a weaker one: the JAX
    package's wall law needs y+ >= 10 at every wall face, see
    ``WALL_LAW_CLUSTER``).

    The files: ``output_frequency`` and ``restart_frequency`` (steps; 0
    writes no restart), ``output_variables`` and
    ``wall_output_variables`` (sequences of names, None for the deck's
    defaults), ``output_nodal`` (nodal function files); ``ic_file`` a
    point-cloud initial condition, a file name looked up beside the deck
    and then in the working directory.  Each line is written only when
    it differs from the deck's template.

    The physics: ``face_reconstruction`` (thirdOrder MUSCL, constant,
    weno, wenoZ), ``viscous_face_reconstruction`` (central,
    centralFourth), ``inviscid_flux`` (roe, ausm) and
    ``thermodynamic_model`` (caloricallyPerfect, thermallyPerfect; its
    line is written only for thermallyPerfect).
    Every default writes the deck and grid of before these keywords, byte
    for byte."""
    turb = ("; turbulenceIntensity=0.01; eddyViscosityRatio=10.0"
            if equation_set == "rans" else "")
    inviscid = equation_set == "euler"
    wall = (f"slipWall  0 {ni} 0 0 0 {nk} 0" if inviscid
            else f"viscousWall  0 {ni} 0 0 0 {nk} 2")
    wall_law = ("" if wall_treatment == "lowRe"
                else f"; wallTreatment={wall_treatment}")
    wall_state = ("" if inviscid else
                  f", viscousWall(tag=2; temperature={wall_temperature}"
                  f"{wall_law})")
    fluids, mf, mixture = "fluid(name=air; referenceMassFraction=1.0)", "", ""
    if species is not None:
        fluids = ", ".join(f"fluid(name={s}; referenceMassFraction={m})"
                           for s, m in zip(species, mass_fractions))
        mf = "; massFractions=[" + ", ".join(
            f"{s}={m}" for s, m in zip(species, mass_fractions)) + "]"
        mixture = f"diffusionModel: {diffusion}\n"
        if chemistry is not None:
            mixture += ("chemistryModel: reacting\n"
                        f"chemistryMechanism: {chemistry}\n")
    if not inviscid:
        wall_state = wall_state[:-1] + mf + ")"
    lodi = (f"; nonreflecting=true; lengthScale={PLATE_LENGTH}"
            if nonreflecting else "")
    free = (f"pressure=101300.0; density={density}; "
            f"velocity=[{velocity}, 0.0, 0.0]{turb}{mf}")
    states, inflow_tag, outflow_tag, span_tags = "", 1, 1, (0, 0)
    if inflow == "inlet":
        states += f", inlet(tag=3; {free}{lodi})"
    elif inflow == "stagnationInlet":
        p0, t0 = stagnation_state(density, velocity, species,
                                  mass_fractions)
        states += (f", stagnationInlet(tag=3; p0={p0!r}; t0={t0!r}; "
                   f"direction=[1.0, 0.0, 0.0]{turb}{mf})")
    elif inflow == "supersonicInflow":
        states += f", supersonicInflow(tag=3; {free})"
    if inflow != "characteristic":
        inflow_tag = 3
    if outflow == "pressureOutlet":
        states += f", pressureOutlet(tag=6; pressure=101300.0{lodi})"
        outflow_tag = 6
    elif outflow == "supersonicOutflow":
        outflow_tag = 0
    if span == "periodic":
        states += (f", periodic(startTag=4; endTag=5; "
                   f"translation=[0.0, 0.0, {PLATE_WIDTH}])")
        span_tags = (4, 5)
    time_lines = ""
    if time_step != 0.0:
        time_lines += f"timeStep: {time_step}\n"
    if nonlinear_iterations != 1:
        time_lines += f"nonlinearIterations: {nonlinear_iterations}\n"
    if dual_time_cfl > 0.0:
        time_lines += f"dualTimeCFL: {dual_time_cfl}\n"
    output_lines = ""
    if restart_frequency != 0:
        output_lines += f"restartFrequency: {restart_frequency}\n"
    for key, names in (("outputVariables", output_variables),
                       ("wallOutputVariables", wall_output_variables)):
        if names is not None:
            output_lines += f"{key}: <{', '.join(names)}>\n"
    if output_nodal:
        output_lines += "outputNodalVariables: true\n"
    ic = (f"file={ic_file}" if ic_file is not None else
          f"pressure=101300.0; density={density}; "
          f"velocity=[{velocity}, 0.0, 0.0]{turb}{mf}")
    thermo_lines = ("" if thermodynamic_model == "caloricallyPerfect" else
                    f"thermodynamicModel: {thermodynamic_model}\n")
    mg_lines = ""
    if multigrid_levels != 1:
        mg_lines += f"multigridLevels: {multigrid_levels}\n"
    if multigrid_cycle != "V":
        mg_lines += f"multigridCycle: {multigrid_cycle}\n"
    os.makedirs(out_dir, exist_ok=True)
    for tracer in set(species or ()) & set(TRACERS):
        with open(os.path.join(out_dir, f"{tracer}.dat"), "w") as f:
            f.write(species_file_text(*TRACERS[tracer]))
    if chemistry is not None:
        with open(os.path.join(out_dir, f"{chemistry}.mch"), "w") as f:
            f.write(MECHANISMS[chemistry])
    write_p3d(os.path.join(out_dir, f"{name}.xyz"),
              plate_nodes(ni, nj, nk, cluster))
    deck_path = os.path.join(out_dir, f"{name}.inp")
    with open(deck_path, "w") as f:
        f.write(_DECK.format(grid=name, iterations=iterations, ni=ni, nj=nj,
                             nk=nk, matrix_sweeps=matrix_sweeps,
                             matrix_solver=matrix_solver,
                             equation_set=equation_set,
                             turbulence_model=turbulence_model, turb=turb,
                             wall=wall, wall_state=wall_state, mf=mf,
                             fluids=fluids, mixture=mixture,
                             density=density,
                             time_integration=time_integration,
                             time_lines=time_lines, mg_lines=mg_lines,
                             inviscid_flux_jacobian=inviscid_flux_jacobian,
                             cfl=tuple(float(c) for c in cfl),
                             velocity=velocity, states=states,
                             inflow=inflow, inflow_tag=inflow_tag,
                             outflow=outflow, outflow_tag=outflow_tag,
                             span=span, span_tags=span_tags,
                             output_frequency=output_frequency,
                             output_lines=output_lines, ic=ic,
                             inviscid_flux=inviscid_flux,
                             face_reconstruction=face_reconstruction,
                             viscous_face_reconstruction=(
                                 viscous_face_reconstruction),
                             thermo_lines=thermo_lines))
    return deck_path


def write_cloud(path: str, counts=(6, 4, 3), seed: int = 0,
                density: float = 1.2256, velocity: float = 68.0,
                species=None, mass_fractions=None) -> np.ndarray:
    """Write a point-cloud initial condition for the plate to ``path`` in
    the format ``io/cloud.py`` reads (line 1 the point count, line 2 the
    species, then rows ``x y z rho u v w p tke omega mf...`` in SI units,
    written with repr so that they read back exactly): a lattice of
    ``counts`` points over the plate's box (both blocks), each point
    twice with different states, so that every cell's nearest points tie
    exactly and the k-d tree's traversal picks one.  The states are the
    plate's freestream (``density``, ``velocity``, 101300 Pa, the mixture
    of ``species``) times (1 + 0.05 U[0, 1)), seeded.  Returns the rows."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0.0, extent, n) for extent, n in zip(
        (PLATE_LENGTH, PLATE_HEIGHT, PLATE_WIDTH), counts)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    pts = np.repeat(pts, 2, axis=0)
    n = len(pts)
    names = species or ("air",)
    mfs = np.asarray(mass_fractions or (1.0,))
    tke = 1.5 * (0.01 * velocity) ** 2
    omega = density * tke / (10.0 * 1.8e-5)
    base = np.array([density, velocity, 0.0, 0.0, 101300.0, tke, omega])
    state = base * (1.0 + 0.05 * rng.random((n, len(base))))
    rows = np.concatenate([pts, state, np.tile(mfs, (n, 1))], axis=1)
    with open(path, "w") as f:
        f.write(f"{n}\n{' '.join(names)}\n")
        for row in rows:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
    return rows
