"""PyTorch port, its own host layers: the copies of aither_tpu's deck
parser, Plot3D reader and writer, species database, geometry, connections,
ghost nodes and decomposition (``aither_tpu_torch/{io,grid,parallel}``,
``physics/fluid.py``) give the JAX package's results on the generated
plate, whole and decomposed into 4; and no module of the port, nor
chip_smoke.py, imports aither_tpu or jax.

Tolerance: none — the copies are the same host numpy code, so every
array is compared for equality.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

from tests.torch_parity import write_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "aither_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _same(a, b, what):
    """equal values, recursing through dataclasses (the two packages'
    classes differ), dicts, sequences and numpy arrays"""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    wd = tmp_path_factory.mktemp("plate")
    return wd, write_case(wd, (6, 12, 4))


def _grids(deck_mod, p3d_mod, path):
    deck = deck_mod.parse_deck(path).finalize()
    grids = p3d_mod.read_p3d(os.path.join(os.path.dirname(path),
                                          deck["gridName"] + ".xyz"),
                             deck.l_ref)
    return deck, grids


def test_deck_plot3d_and_fluid(plate, tmp_path):
    from aither_tpu.io import deck as jdeck
    from aither_tpu.io import plot3d as jp3d
    from aither_tpu.physics import fluid as jfluid
    from aither_tpu_torch.io import deck as tdeck
    from aither_tpu_torch.io import plot3d as tp3d
    from aither_tpu_torch.physics import fluid as tfluid
    _, path = plate
    jd, jg = _grids(jdeck, jp3d, path)
    td, tg = _grids(tdeck, tp3d, path)
    _same(td.values, jd.values, "values")
    _same(td.bcs, jd.bcs, "bcs")
    _same(td.bc_states, jd.bc_states, "bc_states")
    for attr in ("a_ref", "l_ref", "r_ref", "t_ref", "num_ghosts",
                 "num_equations", "is_viscous", "is_turbulent"):
        assert getattr(td, attr) == getattr(jd, attr), attr
    assert td.cfl(3) == jd.cfl(3)
    assert (td.matrix_requires_initialization()
            == jd.matrix_requires_initialization())
    _same(td._fluid_props, jd._fluid_props, "fluid props")
    _same(tfluid.load_fluid("air"), jfluid.load_fluid("air"), "air")
    _same(tg, jg, "grid")
    jp3d.write_p3d(str(tmp_path / "j.xyz"), jg)
    tp3d.write_p3d(str(tmp_path / "t.xyz"), tg)
    assert (tmp_path / "j.xyz").read_bytes() == (tmp_path / "t.xyz").read_bytes()


def _host_case(pkg, path, nproc):
    """decomposition, connections, geometry and interblock ghost geometry
    of one package's host layers"""
    import importlib
    deck_mod = importlib.import_module(f"{pkg}.io.deck")
    p3d_mod = importlib.import_module(f"{pkg}.io.plot3d")
    conn = importlib.import_module(f"{pkg}.grid.connections")
    geo = importlib.import_module(f"{pkg}.grid.geometry")
    ghost = importlib.import_module(f"{pkg}.grid.ghost_nodes")
    dec = importlib.import_module(f"{pkg}.parallel.decompose")
    deck, grids = _grids(deck_mod, p3d_mod, path)
    bcs, decomp = deck.bcs, None
    if nproc > 1:
        grids, bcs, decomp = dec.decompose(grids, bcs, nproc,
                                           method=deck["decompositionMethod"])
    g = deck.num_ghosts
    conns = conn.find_connections(bcs, grids, deck.bc_states,
                                  l_ref=deck.l_ref)
    geos = [geo.build_block_geometry(nodes, bc, g, finalize=False)
            for nodes, bc in zip(grids, bcs)]
    ghost.fill_interblock_geometry(geos, conns, grids, g)
    for gm in geos:
        geo.finalize_block_geometry(gm)
    return dict(grids=grids, bcs=bcs, decomp=decomp, conns=conns, geos=geos)


@pytest.mark.parametrize("nproc", [1, 4])
def test_geometry_connections_ghosts_decomposition(plate, nproc):
    _, path = plate
    want = _host_case("aither_tpu", path, nproc)
    got = _host_case("aither_tpu_torch", path, nproc)
    assert len(got["geos"]) == (2 if nproc == 1 else 4)
    assert len(got["conns"]) == (1 if nproc == 1 else 4)
    for key in ("grids", "bcs", "decomp", "conns", "geos"):
        _same(got[key], want[key], key)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_helpers(orientation):
    """the numpy-only orientation helpers of the connections copy"""
    from aither_tpu.grid import connections as jc
    from aither_tpu_torch.grid import connections as tc
    donor = np.arange(4 * 5 * 3).reshape(4, 5, 3)
    for direction in "ijk":
        for fn in ("orient_to_first", "orient_to_second"):
            want = getattr(jc, fn)(donor, orientation, 0, 1, direction)
            got = getattr(tc, fn)(donor, orientation, 0, 1, direction)
            np.testing.assert_array_equal(got, want)


def test_no_import_of_the_jax_package():
    """AST scan: no import or from-import of aither_tpu or jax in the
    port's modules or in chip_smoke.py (relative imports stay inside the
    port)."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("aither_tpu", "jax", "jaxlib"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} {name}")
    assert len(_port_sources()) > 20
    assert not bad, bad


# ---------------------------------------------------------------------------
# the output, restart and point-cloud copies (io/output.py, io/restart.py,
# io/cloud.py, utils/native.py with csrc/kdtree.cpp)

NEW_COPIES = ("aither_tpu_torch/io/output.py", "aither_tpu_torch/io/restart.py",
              "aither_tpu_torch/io/cloud.py",
              "aither_tpu_torch/utils/native.py")


def test_no_import_scan_covers_the_file_modules():
    """the AST scan above reads the new modules"""
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert set(NEW_COPIES) <= scanned


def _decks_phys(path):
    from aither_tpu.io.deck import parse_deck as jparse
    from aither_tpu.physics.models import Physics as JPhysics
    from aither_tpu_torch.io.deck import parse_deck as tparse
    from aither_tpu_torch.physics.models import Physics as TPhysics
    jd, td = jparse(path).finalize(), tparse(path).finalize()
    return (jd, JPhysics.from_deck(jd)), (td, TPhysics.from_deck(td))


FUN_VARS = ("density", "vel_x", "vel_y", "vel_z", "pressure", "temperature",
            "viscosity", "tke", "sdr", "wallDistance",
            "turbulentViscosity", "viscosityRatio", "cp", "cv", "energy",
            "enthalpy", "dt", "f1", "f2", "rank", "globalPosition",
            "velGrad_uy", "tempGrad_x", "densityGrad_z", "pressGrad_y",
            "tkeGrad_x", "omegaGrad_z", "resid_mass", "resid_mom_y",
            "resid_energy", "resid_sdr", "mf_air")
# the speed of sound of one species: the port's Physics takes gamma as the
# constant cp / cv, the JAX package's as the ratio of the mixed fields;
# the two differ in the last bit
SOS_VARS = ("mach", "sos")
WALL_VARS = ("yplus", "shearStress", "viscosityRatio", "heatFlux",
             "frictionVelocity", "density", "pressure", "temperature",
             "viscosity", "tke", "sdr")


def _fields(seed=3, shape=(7, 5, 3)):
    """seeded interior primitives of two blocks and their aux dicts (the
    driver's layout: numpy fields and cell averages)"""
    rng = np.random.default_rng(seed)
    prims, auxs = [], []
    for b in range(2):
        shp = shape[:2] + (shape[2] + b,)
        prim = np.empty((7,) + shp)
        prim[0] = 1.0 + 0.1 * rng.random(shp)
        prim[1:4] = 0.2 * rng.standard_normal((3,) + shp)
        prim[4] = 1.0 / 1.4 * (1.0 + 0.1 * rng.random(shp))
        prim[5:] = 1e-3 * (1.0 + rng.random((2,) + shp))
        f = lambda *lead: rng.standard_normal(lead + shp)   # noqa: E731
        aux = dict(wall_dist=rng.random(shp), temperature=1.0 + f() * 0.01,
                   viscosity=1.0 + 0.01 * f(), dt=rng.random(shp),
                   resid=f(7), mut=rng.random(shp), f1=rng.random(shp),
                   f2=rng.random(shp), rank=np.full(shp, 1.0),
                   globalPosition=np.full(shp, float(b)),
                   cellavg=dict(vel=f(3, 3), temp=f(3), rho=f(3), press=f(3),
                                tke=f(3), omega=f(3)))
        prims.append(prim)
        auxs.append(aux)
    return prims, auxs


def _wall_blocks(spec_cls, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for bi, (d, shp) in enumerate((("j", (7, 3)), ("k", (7, 5)))):
        spec = spec_cls(bc_type="viscousWall", direction=d, lower=bi == 0,
                        tag=2, patch=((2, 9), (2, 2 + shp[1])))
        wd = dict(tau=rng.standard_normal((3,) + shp), q=rng.standard_normal(
            shp), rho=1.0 + rng.random(shp), t=1.0 + rng.random(shp),
            mu=1.0 + rng.random(shp), mut=rng.random(shp),
            u_star=rng.random(shp), yplus=rng.random(shp),
            tke=rng.random(shp), sdr=rng.random(shp))
        out.append((bi, spec, rng.random(shp + (3,)), wd))
    return out


def test_output_writers_byte_identical(plate, tmp_path):
    """cell-center grid, node grid, function files (every variable kind,
    the Physics ones through each package's Physics), wall files, meta
    files and restart files of the two copies on the same numpy inputs:
    byte for byte, but for the speed-of-sound fields (SOS_VARS: within
    one unit in the last place, 4.5e-16 relative); the readers return
    equal arrays"""
    from aither_tpu.io import output as jout
    from aither_tpu.io import restart as jrst
    from aither_tpu.solver.case import SurfaceSpec as JSpec
    from aither_tpu_torch.io import output as tout
    from aither_tpu_torch.io import restart as trst
    from aither_tpu_torch.solver.case import SurfaceSpec as TSpec
    _, path = plate
    (jd, jp), (td, tp) = _decks_phys(path)
    prims, auxs = _fields()
    rng = np.random.default_rng(5)
    centers = [rng.random((4, 3, 2, 3)), rng.random((2, 2, 2, 3))]
    for pkg, out, rst, deck, phys, spec in (
            ("j", jout, jrst, jd, jp, JSpec), ("t", tout, trst, td, tp, TSpec)):
        d = tmp_path / pkg
        d.mkdir()
        out.write_cell_center(str(d / "c.xyz"), centers, deck.l_ref)
        out.write_nodes(str(d / "n.xyz"), centers, deck.l_ref)
        out.write_fun_file(str(d / "f.fun"), FUN_VARS, prims, phys, deck,
                           auxs)
        out.write_fun_file(str(d / "s.fun"), SOS_VARS, prims, phys, deck,
                           auxs)
        out.write_meta(str(d / "m.p3d"), str(d / "sim"), "grid", 3,
                       FUN_VARS)
        out.write_meta(str(d / "n.p3d"), str(d / "sim"), "grid", 3,
                       FUN_VARS, is_center=False)

        class _Case:
            pass
        case = _Case()
        case.deck, case.phys = deck, phys
        out.write_wall_files(str(d / "sim"), "grid", 3, case,
                             _wall_blocks(spec), list(WALL_VARS))
        rst.write_restart(str(d / "r.rst"), deck, phys, 3,
                          np.arange(7.0) + 0.5, prims,
                          [p * 1.1 for p in prims], mu_ref=phys.mu_mix_ref)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 9
    (dims, got), (want_dims, want) = (
        out_mod.read_fun_file(str(tmp_path / pkg / "s.fun"))
        for pkg, out_mod in (("t", tout), ("j", jout)))
    np.testing.assert_array_equal(dims, want_dims)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_, w_, rtol=4.5e-16, atol=0)
    names.remove("s.fun")
    for name in names:
        assert ((tmp_path / "j" / name).read_bytes()
                == (tmp_path / "t" / name).read_bytes()), name
    for name in ("f.fun", "sim_3_wall_center.fun"):
        _same(tout.read_fun_file(str(tmp_path / "t" / name)),
              jout.read_fun_file(str(tmp_path / "j" / name)), name)
    r = str(tmp_path / "t" / "r.rst")
    _same(trst.read_restart(r), jrst.read_restart(r), "read_restart")
    rec = trst.read_restart(r)
    for fn in ("prim_from_restart", "cons_from_restart"):
        for blk in rec["blocks"]:
            np.testing.assert_array_equal(
                getattr(trst, fn)(blk, tp, td, tp.mu_mix_ref),
                getattr(jrst, fn)(blk, jp, jd, jp.mu_mix_ref), err_msg=fn)


@pytest.mark.parametrize("fn", ["assign_corner_ghosts", "cell_to_node_state",
                                "cell_to_node_ghost_ignore_edge",
                                "cell_to_node_noghost_ignore_edge",
                                "face_grads_to_node"])
def test_node_interpolation_equal(fn):
    """the cell-to-node functions of both copies on seeded arrays"""
    from aither_tpu.io import output as jout
    from aither_tpu_torch.io import output as tout
    rng = np.random.default_rng(6)
    dims, g = (5, 4, 3), 2
    if fn == "face_grads_to_node":
        faces = {d: rng.standard_normal(
            (3,) + tuple(n + (a == k) for k, n in enumerate(dims)))
            for a, d in enumerate("ijk")}
        args = (faces, dims)
    elif fn == "cell_to_node_noghost_ignore_edge":
        args = (rng.standard_normal((2,) + dims),)
    else:
        args = (rng.standard_normal((2,) + tuple(n + 2 * g for n in dims)),
                g)
    np.testing.assert_array_equal(getattr(tout, fn)(*args),
                                  getattr(jout, fn)(*args))


def test_cloud_and_nearest_neighbours(plate, tmp_path):
    """load_cloud of both copies on a cloud written by cases.write_cloud;
    the copied k-d tree's nearest indices equal the JAX package's on an
    8 x 8 x 8 lattice queried at the 7 x 7 x 7 cell midpoints and at the
    lattice points themselves with every point doubled: ties everywhere,
    and more points than the tree's 32-point leaf, so that its traversal
    decides them (a brute-force argmin disagrees on most queries)"""
    from aither_tpu.io.cloud import load_cloud as jload
    from aither_tpu.utils.native import nearest_neighbors as jnn
    from aither_tpu_torch.cases import write_cloud
    from aither_tpu_torch.io.cloud import load_cloud as tload
    from aither_tpu_torch.utils.native import nearest_neighbors as tnn
    _, path = plate
    (jd, jp), (td, tp) = _decks_phys(path)
    write_cloud(str(tmp_path / "c.dat"))
    _same(tload(str(tmp_path / "c.dat"), td, tp),
          jload(str(tmp_path / "c.dat"), jd, jp), "load_cloud")
    x = np.arange(8.0)
    lattice = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    mid = lattice.reshape(8, 8, 8, 3)[:-1, :-1, :-1].reshape(-1, 3) + 0.5
    for pts, queries in ((lattice, mid),
                         (np.repeat(lattice, 2, axis=0), lattice)):
        got, gd = tnn(pts, queries)
        want, wd = jnn(pts, queries)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gd, wd)
        d2 = ((queries[:, None] - pts[None]) ** 2).sum(-1)
        assert (d2.argmin(axis=1) != got).sum() > len(queries) // 2
