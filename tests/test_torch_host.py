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
