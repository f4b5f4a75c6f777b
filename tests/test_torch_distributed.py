"""PyTorch port, multi-rank runs (``aither_tpu_torch/parallel/``) on the
CPU with gloo, against the one-rank run and the JAX package:

(a) the rank exchange plans (``step.rank_exchange_plan`` /
    ``RankExchange``), run in one process with the transport replaced by
    queues, reproduce ``swap_connections`` exactly: the plate at
    ``--nproc 2``, at ``--nproc 4`` (four connections meeting), with a
    periodic span, and on the coarse levels of a 3-level case;
(b) 2 ranks (``launch_local``), SST lusgs, ``--nproc 2``, 3 iterations:
    the ``.resid`` text and every file equal to the one-rank run's, byte
    for byte, with jax and aither_tpu unimportable in the ranks;
(c) 4 ranks at ``--nproc 4`` (the corner exchange), laminar lusgs, 2
    iterations, as (b);
(d) 2 ranks, SST blusgs on a 2-level V cycle, 2 iterations, as (b);
(e) a 2-rank resume from the one-rank run's ``.rst`` continues as the
    one-rank resume does (``.resid`` and files byte for byte); and 2
    ranks of a LODI bdf2 deck, whose carry and time n-1 solution stay
    per block, and of an explicit rk4 deck, as (b);
(f) 2 ranks (threads, each with its own gloo group) against the JAX
    package's decomposed ``Solver(nproc=2)``: one iteration from the same
    carried-in state (``set_state`` scattering rank 0's state), at the
    slice tolerance of ``test_torch_slice.py``;
(g) the refusals: more ranks than blocks, ``--shard 2`` on the card with
    no card, the case directory given to a rank other than 0, and a NaN
    planted on rank 1 stopping every rank with its block and cell.

Every rank and every one-rank run it is held to takes one torch thread.
"""

import datetime
import filecmp
import os
import queue
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aither_tpu_torch.cases import TEST_DIMS, write_plate_case  # noqa: E402
from aither_tpu_torch.parallel.distributed import (  # noqa: E402
    Comm, distribute_case, launch_local, rank_commands, rank_device)
from aither_tpu_torch.parallel.shard import block_owners  # noqa: E402
from aither_tpu_torch.solver import step as tstep  # noqa: E402
from aither_tpu_torch.solver.case import build_case  # noqa: E402
from aither_tpu_torch.solver.driver import Solver  # noqa: E402

CORNER_DIMS = (6, 12, 4)       # --nproc 4 splits the plate in j too
MG_DIMS = (12, 8, 4)           # three multigrid levels at --nproc 2
CASE_FILES = {"plate.inp", "plate.xyz"}

# the ranks run with jax and the JAX package unimportable, and say at exit
# whether either was loaded
BLOCKER = """import atexit, sys
sys.modules["jax"] = None
sys.modules["aither_tpu"] = None


def _report():
    loaded = [m for m, v in sys.modules.items() if v is not None
              and m.split(".")[0] in ("jax", "aither_tpu")]
    print("NOJAX_OK" if not loaded else f"LOADED {loaded}", flush=True)


atexit.register(_report)
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rank_env(tmp_path_factory):
    d = tmp_path_factory.mktemp("blocker")
    (d / "sitecustomize.py").write_text(BLOCKER)
    return {"OMP_NUM_THREADS": "1", "PYTHONPATH": str(d)}


def run_threads(world, fn, timeout=120):
    """``fn(comm)`` on ``world`` ranks, each a thread with a gloo group of
    its own over one in-memory store: (results, exceptions) by rank"""
    import torch.distributed as dist
    store = dist.HashStore()
    results, errors = [None] * world, [None] * world

    def body(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("ranks", store), r,
                                       world,
                                       datetime.timedelta(seconds=timeout))
            results[r] = fn(Comm(pg, r, world, "cpu"))
        except Exception as exc:       # noqa: BLE001 - handed back
            errors[r] = exc

    threads = [threading.Thread(target=body, args=(r,)) for r in
               range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    assert not any(t.is_alive() for t in threads), "a rank hangs"
    return results, errors


# ---------------------------------------------------------------------------
# (a) the exchange plans against swap_connections


class QueueTransport:
    """``Comm.sendrecv`` between threads: one FIFO per ordered rank pair"""

    def __init__(self, rank, queues):
        self.rank, self.queues = rank, queues

    def sendrecv(self, peer, send, recv_shape):
        self.queues[(self.rank, peer)].put(send.clone())
        got = self.queues[(peer, self.rank)].get(timeout=30)
        assert tuple(got.shape) == tuple(recv_shape)
        return got


def split_swap(maps, fields, owners):
    """every rank's ``RankExchange.swap`` of its own blocks of ``fields``,
    each rank a thread, merged back"""
    world = max(owners) + 1
    queues = {(a, b): queue.Queue() for a in range(world)
              for b in range(world)}
    out, errors = {}, []

    def body(r):
        try:
            plan = tstep.rank_exchange_plan(maps, owners, r, "cpu")
            mine = {b: f.clone() for b, f in fields.items() if owners[b] == r}
            tstep.RankExchange(plan, QueueTransport(r, queues)).swap(mine)
            out.update(mine)
        except Exception as exc:       # noqa: BLE001 - handed back
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(r,)) for r in
               range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return out


def layout_cases(tmp_path, layout):
    """the Cases (one per grid level) of a layout, one rank"""
    from aither_tpu_torch.solver.multigrid import build_levels
    if layout == "nproc2":
        return [build_case(write_plate_case(str(tmp_path), *TEST_DIMS),
                           "cpu", nproc=2)]
    if layout == "nproc4":
        return [build_case(write_plate_case(str(tmp_path), *CORNER_DIMS),
                           "cpu", nproc=4)]
    if layout == "periodic":
        return [build_case(write_plate_case(str(tmp_path), *TEST_DIMS,
                                            span="periodic"), "cpu",
                           nproc=2)]
    case = build_case(write_plate_case(str(tmp_path), *MG_DIMS,
                                       multigrid_levels=3), "cpu", nproc=2)
    return build_levels(case, 3)[0]


@pytest.mark.parametrize("layout", ["nproc2", "nproc4", "periodic",
                                    "coarse"])
def test_rank_plans_reproduce_swap_connections(tmp_path, layout):
    rng = np.random.default_rng(11)
    for lvl, case in enumerate(layout_cases(tmp_path, layout)):
        nb = len(case.blocks)
        cells = [b.ni * b.nj * b.nk for b in case.blocks]
        for world in sorted({2, nb}):
            owners = block_owners(cells, world)
            remote = sum(len({owners[a], owners[d]}) == 2
                         for sides in case.swap_maps
                         for a, _, d, _ in sides)
            assert remote, (layout, lvl, world, "no remote side")
            fields = {b.index: torch.as_tensor(rng.random((3,) + b.shape))
                      for b in case.blocks}
            want = tstep.swap_connections(
                {b: f.clone() for b, f in fields.items()}, case.swap_maps)
            got = split_swap(case.swap_maps, fields, owners)
            assert set(got) == set(want)
            for b in want:
                assert torch.equal(got[b], want[b]), (layout, lvl, world, b)
    if layout == "periodic":
        assert any(len({a, d}) == 1 for sides in case.swap_maps
                   for a, _, d, _ in sides)


# ---------------------------------------------------------------------------
# (b)-(e) launch_local against the one-rank run


def one_rank(case_dir, iterations, nproc, restart=None):
    """the one-process run (no communicator) of ``case_dir/plate.inp``"""
    s = Solver(os.path.join(case_dir, "plate.inp"), device="cpu",
               workdir=str(case_dir), nproc=nproc, restart_path=restart)
    s.run(iterations=iterations, write_files=True)
    return s


def assert_same_run(one_dir, workdirs, outs):
    """rank 0 wrote the one-rank run's files byte for byte (``.tme``
    holds times), the other ranks nothing, and no rank loaded jax"""
    written = sorted(set(os.listdir(one_dir)) - CASE_FILES - {"plate.tme"})
    assert "plate.resid" in written and any(f.endswith(".rst")
                                            for f in written)
    assert sorted(set(os.listdir(workdirs[0])) - CASE_FILES
                  - {"plate.tme"}) == written
    for name in written:
        assert filecmp.cmp(os.path.join(one_dir, name),
                           os.path.join(workdirs[0], name),
                           shallow=False), name
    for wd in workdirs[1:]:
        assert set(os.listdir(wd)) == CASE_FILES
        for name in CASE_FILES:
            assert filecmp.cmp(os.path.join(one_dir, name),
                               os.path.join(wd, name), shallow=False)
    for out in outs:
        assert "NOJAX_OK" in out, out[-2000:]


def ranks_against_one(tmp_path, rank_env, n, nproc, iterations, dims,
                      **deck):
    deck = dict(output_frequency=2, restart_frequency=2, **deck)
    one_dir, src_dir = tmp_path / "one", tmp_path / "src"
    write_plate_case(str(one_dir), *dims, **deck)
    write_plate_case(str(src_dir), *dims, **deck)
    one_rank(str(one_dir), iterations, nproc)
    workdirs, outs = launch_local(n, str(src_dir), "plate.inp",
                                  out_root=str(tmp_path / "ranks"),
                                  iterations=iterations, device="cpu",
                                  nproc=nproc, env=rank_env, rank_timeout=120)
    assert_same_run(str(one_dir), workdirs, outs)
    return one_dir, workdirs


@pytest.fixture(scope="module")
def sst_runs(tmp_path_factory, rank_env):
    """(b): the SST lusgs plate at --nproc 2, one rank and two"""
    tmp = tmp_path_factory.mktemp("sst_ranks")
    return tmp, ranks_against_one(tmp, rank_env, 2, 2, 3, TEST_DIMS)


def test_two_ranks_sst_lusgs(sst_runs):
    _, (one_dir, workdirs) = sst_runs
    with open(os.path.join(workdirs[0], "plate.resid")) as f:
        rows = f.read().splitlines()
    assert len(rows) == 4                  # header + 3 iterations


def test_four_ranks_corner_exchange(tmp_path, rank_env):
    ranks_against_one(tmp_path, rank_env, 4, 4, 2, CORNER_DIMS,
                      equation_set="navierStokes", turbulence_model="none")


def test_two_ranks_blusgs_multigrid(tmp_path, rank_env):
    ranks_against_one(tmp_path, rank_env, 2, 2, 2, MG_DIMS,
                      matrix_solver="blusgs", multigrid_levels=2,
                      multigrid_cycle="V")


def test_two_ranks_carry_per_block(tmp_path, rank_env):
    """the nonreflecting boundaries' carry (bc_aux) and bdf2's time n-1
    solution stay per block: LODI inlet and outlet with dual-time bdf2"""
    from aither_tpu_torch.cases import TIME_INTEGRATORS
    ranks_against_one(tmp_path, rank_env, 2, 2, 2, TEST_DIMS,
                      inflow="inlet", outflow="pressureOutlet",
                      nonreflecting=True, **TIME_INTEGRATORS["bdf2"])


def test_two_ranks_explicit(tmp_path, rank_env):
    """an explicit deck (rk4, its four stages; no matrix residual)"""
    from aither_tpu_torch.cases import TIME_INTEGRATORS
    ranks_against_one(tmp_path, rank_env, 2, 2, 2, TEST_DIMS,
                      equation_set="navierStokes", turbulence_model="none",
                      **TIME_INTEGRATORS["rk4"])


def test_two_rank_resume(sst_runs, rank_env):
    tmp, (one_dir, _) = sst_runs
    rst = os.path.join(one_dir, "plate_2.rst")
    again_dir, src_dir = tmp / "again", tmp / "again_src"
    for d in (again_dir, src_dir):
        write_plate_case(str(d), *TEST_DIMS, output_frequency=2,
                         restart_frequency=2)
    one_rank(str(again_dir), 2, 2, restart=rst)
    workdirs, outs = launch_local(2, str(src_dir), "plate.inp",
                                  out_root=str(tmp / "again_ranks"),
                                  iterations=2, device="cpu", nproc=2,
                                  restart=rst, env=rank_env, rank_timeout=120)
    assert_same_run(str(again_dir), workdirs, outs)
    with open(os.path.join(workdirs[0], "plate.resid")) as f:
        steps = [int(ln.split()[0]) for ln in f.read().splitlines()[1:]]
    assert steps == [2, 3]


# ---------------------------------------------------------------------------
# (f) against the JAX package


def test_two_ranks_one_iteration_against_jax(tmp_path):
    from tests.torch_parity import (jax_solver, jax_step, np_,
                                    perturbed_prims, quick_jax_compiles,
                                    rel_err, write_case)
    path = write_case(tmp_path)
    import jax.numpy as jnp
    with quick_jax_compiles():
        js = jax_solver(path, tmp_path, nproc=2)
        prims = perturbed_prims(js.case.blocks)
        js.prims = {b: jnp.asarray(v) for b, v in prims.items()}
        js.cons_n = js.store_old_solution()
        cons_n = {b: np_(v) for b, v in js.cons_n.items()}
        want_prims, want_l2, want_mr = jax_step(js, 0)

    def rank(comm):
        ts = Solver(path, device="cpu", workdir=str(tmp_path), nproc=2,
                    comm=comm)
        if comm.rank == 0:
            ts.set_state(prims, cons_n)
        else:
            ts.set_state(None)
        return ts, ts._iteration(dict(ts.prims), ts.cons_n, ts.deck.cfl(0))

    results, errors = run_threads(2, rank)
    assert errors == [None, None], errors
    seen = []
    for ts, (got_prims, got_l2, _, got_mr, _) in results:
        for b in ts.case.blocks:
            seen.append(b.index)
            g = b.g
            for e in range(ts.phys.neq):
                w = np_(want_prims[b.index])[e, g:g + b.ni, g:g + b.nj,
                                             g:g + b.nk]
                t = got_prims[b.index][b.interior][e]
                assert rel_err(t, w) < 1e-10, (b.index, e, rel_err(t, w))
        np.testing.assert_allclose(np_(got_l2), want_l2, rtol=1e-10)
        assert abs(float(got_mr) - want_mr) <= 1e-9 * abs(want_mr)
    assert sorted(seen) == list(range(len(js.case.blocks)))


# ---------------------------------------------------------------------------
# (g) the refusals


def test_block_owners():
    assert block_owners([5, 9, 7, 3], 2) == [1, 0, 1, 0]
    assert block_owners([5, 9, 7, 3], 2, decomp_rank=[0, 0, 1, 1]) == [
        0, 0, 1, 1]
    # a decomposition for another rank count is not taken
    assert block_owners([5, 9, 7, 3], 3, decomp_rank=[0, 0, 1, 1]) == [
        2, 0, 1, 2]


def test_more_ranks_than_blocks(tmp_path):
    with pytest.raises(ValueError, match="3 ranks but 2 blocks"):
        block_owners([10, 10], 3)
    path = write_plate_case(str(tmp_path), *TEST_DIMS)
    with pytest.raises(ValueError, match="3 ranks but 2 blocks"):
        build_case(path, "cpu", comm=Comm(None, 0, 3))


def test_shard_on_the_card_without_one(tmp_path, monkeypatch):
    from aither_tpu_torch.main import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = write_plate_case(str(tmp_path), *TEST_DIMS)
    with pytest.raises(RuntimeError, match="cuda"):
        main([path, "--shard", "2", "--iterations", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        rank_device("cuda", 0)
    assert set(os.listdir(tmp_path)) == CASE_FILES


def test_only_rank_zero_reads_the_case(tmp_path):
    cmds = rank_commands(3, 1234, "/case", "plate.inp", ["a", "b", "c"],
                         restart="/case/plate_2.rst")
    assert ["--case-dir" in c for c in cmds] == [True, False, False]
    assert ["--restart" in c for c in cmds] == [True, False, False]
    with pytest.raises(ValueError, match="only rank 0"):
        distribute_case(Comm(None, 1, 2), str(tmp_path / "w"),
                        src_dir=str(tmp_path))


def test_nan_on_rank_one_stops_every_rank(tmp_path):
    path = write_plate_case(str(tmp_path), *CORNER_DIMS)

    def rank(comm):
        ts = Solver(path, device="cpu", workdir=str(tmp_path), nproc=4,
                    comm=comm, debug=True)
        if comm.rank == 1:
            b = ts.case.blocks[-1]
            ts.prims[b.index][(0, b.g + 2, b.g + 1, b.g)] = float("nan")
            planted.append((b.parent, (2, 1, 0)))
        ts.check_physicality(0, 0)

    planted = []
    _, errors = run_threads(2, rank)
    (parent, cell), = planted
    msgs = {str(e) for e in errors}
    assert all(isinstance(e, FloatingPointError) for e in errors), errors
    assert msgs == {f"non-physical density nan at iteration 0 "
                    f"nonlinear-iter 0, block {parent}, cell {cell}"}


def test_import_scan_covers_the_rank_modules():
    """tests/test_torch_host.py's scan for imports of jax or the JAX
    package reads the multi-rank modules"""
    from tests.test_torch_host import REPO, _port_sources
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {"aither_tpu_torch/parallel/distributed.py",
            "aither_tpu_torch/parallel/shard.py"} <= scanned
