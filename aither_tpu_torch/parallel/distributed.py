"""Multi-rank runs: one process per rank over ``torch.distributed``.

Counterpart of ``aither_tpu/parallel/distributed.py`` (``initialize`` :39,
``distribute_case`` :69, ``run_distributed`` :102, ``barrier_sync`` :120,
``launch_local`` :152, ``_main`` :201).  The JAX package runs one SPMD
program over a device mesh; the port follows PyTorch's idiom and the
reference's MPI model (reference: src/main.cpp:121-177, one procBlock set
per rank, src/procBlock.cpp:4043-4663 packed ghost exchanges):

* every rank is a process with a gloo process group (``initialize``; bare,
  it reads ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
  ``MASTER_PORT``, so ``torchrun`` starts it too) and one device,
  ``cuda:{LOCAL_RANK % device_count}``, or the CPU when asked for;
* rank 0 alone reads the case directory and broadcasts its files
  (``distribute_case``); every rank writes them into its private working
  directory and builds the host case of the whole grid from there;
* each rank owns whole blocks (``parallel/shard.py``) and holds on its
  device only their state, geometry, statics and sweep plans, runs the
  sweep and viscous kernels on them, and exchanges connection ghosts at
  every grid level (``solver/step.RankExchange``) through ``Comm.sendrecv``:
  gloo with every message staged through host memory (gloo moves CPU
  tensors only), the one transport, which runs unchanged whether the
  ranks share a card or each has its own;
* the norms are gathered per block and reduced in block order on every
  rank, so that the ``.resid`` rows are the one-rank run's; rank 0
  gathers the state for the files and alone writes them.

``launch_local`` starts the ranks of one host; ``python -m
aither_tpu_torch case.inp --shard N`` goes through it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch

# seconds a rank waits for the others at one collective before it fails
DEFAULT_TIMEOUT = 600


class Comm:
    """One rank's communicator: a gloo ``ProcessGroup`` ``pg`` with this
    ``rank`` of ``world`` and the rank's ``device``.  Tensors that cross
    it live on the host."""

    def __init__(self, pg, rank: int, world: int, device="cpu"):
        self.pg = pg
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)

    def sendrecv(self, peer: int, send, recv_shape):
        """send the host tensor ``send`` to ``peer`` and receive its
        tensor of ``recv_shape`` (same dtype); both are posted before
        either is waited for"""
        buf = torch.empty(recv_shape, dtype=send.dtype)
        works = [self.pg.send([send.contiguous()], peer, 0),
                 self.pg.recv([buf], peer, 0)]
        for w in works:
            w.wait()
        return buf

    def all_gather(self, t):
        """[every rank's host tensor ``t``] in rank order"""
        out = [torch.empty_like(t) for _ in range(self.world)]
        self.pg.allgather([out], [t.contiguous()]).wait()
        return out

    def block_rows(self, parts: dict, nblocks: int, owners):
        """``parts`` ({own block: tensor of one shape}) of every rank as one
        host tensor ``[nblocks, ...]``: each row taken from its owner's
        contribution (gathered, no arithmetic, so exact)"""
        first = next(iter(parts.values()))
        rows = torch.zeros((nblocks,) + tuple(first.shape),
                           dtype=first.dtype)
        for b, v in parts.items():
            rows[b] = v.detach().cpu()
        got = self.all_gather(rows)
        return torch.stack([got[owners[b]][b] for b in range(nblocks)])

    def _send_bytes(self, data: bytes, peer: int):
        payload = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        self.pg.send([torch.tensor([payload.numel()], dtype=torch.int64)],
                     peer, 0).wait()
        if payload.numel():
            self.pg.send([payload], peer, 0).wait()

    def _recv_bytes(self, peer: int) -> bytes:
        n = torch.zeros(1, dtype=torch.int64)
        self.pg.recv([n], peer, 0).wait()
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        if buf.numel():
            self.pg.recv([buf], peer, 0).wait()
        return buf.numpy().tobytes()

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` of rank ``src`` on every rank (pickled)"""
        if self.rank == src:
            data = pickle.dumps(obj)
            for r in range(self.world):
                if r != src:
                    self._send_bytes(data, r)
            return obj
        return pickle.loads(self._recv_bytes(src))

    def scatter_objects(self, objs, src: int = 0):
        """rank r receives ``objs[r]`` of rank ``src`` (None elsewhere)"""
        if self.rank == src:
            for r in range(self.world):
                if r != src:
                    self._send_bytes(pickle.dumps(objs[r]), r)
            return objs[src]
        return pickle.loads(self._recv_bytes(src))

    def gather_objects(self, obj, dst: int = 0):
        """[every rank's ``obj``] on rank ``dst``, None elsewhere"""
        if self.rank != dst:
            self._send_bytes(pickle.dumps(obj), dst)
            return None
        return [obj if r == dst else pickle.loads(self._recv_bytes(r))
                for r in range(self.world)]

    def barrier(self):
        self.pg.barrier().wait()


def rank_device(device: str, local_rank: int) -> torch.device:
    """``cuda:{local_rank % device_count}`` for ``device`` 'cuda' (raises
    when no card is present: a rank never falls to the CPU), else the
    CPU"""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False (use device "
                           "'cpu' to run the ranks on the CPU)")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize(rank=None, world_size=None, master_addr=None, master_port=None,
               device="cuda", timeout=DEFAULT_TIMEOUT) -> Comm:
    """Join the job (reference: MPI_Init, main.cpp:121-130): a gloo
    process group over ``tcp://master_addr:master_port`` with a timeout of
    ``timeout`` seconds at every collective, so that a rank whose peer
    died fails instead of waiting forever.  Arguments left None come from
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` (default localhost) and
    ``MASTER_PORT``; the device from ``LOCAL_RANK`` (``rank_device``)."""
    import torch.distributed as dist
    env = os.environ
    rank = int(env["RANK"] if rank is None else rank)
    world_size = int(env["WORLD_SIZE"] if world_size is None else world_size)
    master_addr = master_addr or env.get("MASTER_ADDR", "localhost")
    master_port = int(env["MASTER_PORT"] if master_port is None
                      else master_port)
    dev = rank_device(device, int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{master_addr}:{master_port}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    return Comm(dist.group.WORLD, rank, world_size, dev)


def finalize():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def distribute_case(comm: Comm, workdir, src_dir=None):
    """The rank-0-reads protocol (reference: main.cpp:121-163, only ROOT
    reads inputs): rank 0 reads every file of ``src_dir`` and broadcasts
    {name: bytes}; every rank writes them into its private ``workdir``
    (rank 0 skips that when ``workdir`` is ``src_dir``).  Returns
    ``workdir``."""
    files = None
    if comm.rank == 0:
        if src_dir is None:
            raise ValueError("rank 0 needs the case directory")
        files = {}
        for name in sorted(os.listdir(src_dir)):
            path = os.path.join(src_dir, name)
            if os.path.isfile(path):
                with open(path, "rb") as f:
                    files[name] = f.read()
    elif src_dir is not None:
        raise ValueError(f"rank {comm.rank} was given the case directory: "
                         f"only rank 0 reads it")
    files = comm.broadcast_object(files)
    os.makedirs(workdir, exist_ok=True)
    if comm.rank == 0 and os.path.realpath(workdir) == os.path.realpath(
            src_dir):
        return workdir
    for name, data in files.items():
        with open(os.path.join(workdir, name), "wb") as f:
            f.write(data)
    return workdir


def rank_solver(comm: Comm, deck_path, nproc=1, restart_path=None,
                debug=None, workdir=None):
    """This rank's Solver of the deck (its blocks on ``comm.device``), the
    counterpart of the JAX package's ``Solver.enable_sharding``; every
    rank must call it.  The barrier after set-up is the reference's
    MPI_Barrier (main.cpp:225)."""
    from ..solver.driver import Solver
    solver = Solver(deck_path, device=comm.device, workdir=workdir,
                    nproc=nproc, restart_path=restart_path, debug=debug,
                    comm=comm)
    comm.barrier()
    return solver


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def rank_commands(n, port, case_dir, deck, workdirs, iterations=None,
                  device="cuda", nproc=1, restart=None, write_files=True,
                  debug=None, rank_timeout=DEFAULT_TIMEOUT):
    """the command line of each of ``n`` rank processes (``_main``): only
    rank 0's names the case directory and the restart file"""
    cmds = []
    for i in range(n):
        cmd = [sys.executable, "-m", "aither_tpu_torch.parallel.distributed",
               "--rank", str(i), "--world-size", str(n),
               "--master-port", str(port), "--deck", deck,
               "--workdir", workdirs[i], "--device", device,
               "--nproc", str(nproc), "--timeout", str(rank_timeout)]
        if iterations is not None:
            cmd += ["--iterations", str(iterations)]
        if not write_files:
            cmd.append("--no-files")
        if debug:
            cmd.append("--debug")
        if i == 0:
            cmd += ["--case-dir", case_dir]
            if restart is not None:
                cmd += ["--restart", os.path.abspath(restart)]
        cmds.append(cmd)
    return cmds


def launch_local(n, case_dir, deck, out_root=None, iterations=None,
                 device="cuda", nproc=1, restart=None, write_files=True,
                 debug=None, env=None, rank_timeout=DEFAULT_TIMEOUT,
                 echo=False):
    """Run ``deck`` of ``case_dir`` over ``n`` ranks on this host: ``n``
    processes of ``python -m aither_tpu_torch.parallel.distributed`` on a
    free port.  Only rank 0 is told where the case (and the ``restart``
    file) lives; the others receive it over the broadcast.  Rank ``i``
    works in ``out_root/rank{i}``; without ``out_root`` rank 0 works in
    ``case_dir`` itself (its files land there, as a one-rank run's) and the
    others in temporary directories, removed at the end.  ``env`` adds to
    the ranks' environment; ``rank_timeout`` is the seconds a rank waits
    at one collective (``initialize``); ``echo`` streams
    rank 0's output to this process's (its entry in the outputs is then
    empty).  If a rank exits non-zero the others are killed and
    RuntimeError carries every rank's output tail.  Returns (working
    directories, outputs) by rank."""
    if n < 1:
        raise ValueError(f"{n} ranks")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False (use device "
                           "'cpu' to run the ranks on the CPU)")
    case_dir = os.path.abspath(case_dir)
    tmp = None
    if out_root is None:
        tmp = tempfile.mkdtemp(prefix="aither_ranks_")
        workdirs = [case_dir] + [os.path.join(tmp, f"rank{i}")
                                 for i in range(1, n)]
    else:
        workdirs = [os.path.join(os.path.abspath(out_root), f"rank{i}")
                    for i in range(n)]
    port = _free_port()
    penv = dict(os.environ)
    penv.update(env or {})
    penv["PYTHONPATH"] = _repo_root() + os.pathsep + penv.get("PYTHONPATH",
                                                             "")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        penv.pop(key, None)
    cmds = rank_commands(n, port, case_dir, deck, workdirs, iterations,
                         device, nproc, restart, write_files, debug,
                         rank_timeout)
    procs, logs = [], []
    try:
        for i, cmd in enumerate(cmds):
            os.makedirs(workdirs[i], exist_ok=True)
            log = tempfile.TemporaryFile()
            logs.append(log)
            if echo and i == 0:
                procs.append(subprocess.Popen(cmd, env=penv))
            else:
                procs.append(subprocess.Popen(cmd, env=penv, stdout=log,
                                              stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read().decode(errors="replace"))
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(
                f"{n}-rank run failed:\n" + "\n".join(
                    f"--- rank {i} (rc={p.returncode}) ---\n{o[-4000:]}"
                    for i, (p, o) in enumerate(zip(procs, outs))))
        return workdirs, outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="one rank of a multi-rank aither_tpu_torch run "
                    "(reference: one MPI rank of `mpirun -np N aither`)")
    ap.add_argument("--rank", type=int, default=None,
                    help="this rank (default: $RANK)")
    ap.add_argument("--world-size", type=int, default=None,
                    help="number of ranks (default: $WORLD_SIZE)")
    ap.add_argument("--master-addr", default=None)
    ap.add_argument("--master-port", type=int, default=None)
    ap.add_argument("--case-dir", default=None,
                    help="case directory; given to rank 0 only")
    ap.add_argument("--deck", required=True,
                    help="deck file name inside the case directory")
    ap.add_argument("--workdir", required=True,
                    help="this rank's private working directory")
    ap.add_argument("--restart", default=None,
                    help="restart file; given to rank 0 only")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--no-files", action="store_true")
    ap.add_argument("--debug", action="store_true", default=None)
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT,
                    help="seconds a rank waits at one collective")
    args = ap.parse_args(argv)

    comm = initialize(args.rank, args.world_size, args.master_addr,
                      args.master_port, device=args.device,
                      timeout=args.timeout)
    try:
        if comm.rank and args.restart is not None:
            raise ValueError(f"rank {comm.rank} was given the restart file: "
                             f"only rank 0 reads it")
        distribute_case(comm, args.workdir, src_dir=args.case_dir)
        solver = rank_solver(comm, os.path.join(args.workdir, args.deck),
                             nproc=args.nproc, restart_path=args.restart,
                             debug=args.debug, workdir=args.workdir)
        where = (torch.cuda.get_device_name(solver.device)
                 if solver.device.type == "cuda" else "cpu")
        t0 = time.perf_counter()
        solver.run(iterations=args.iterations,
                   write_files=not args.no_files)
        seconds = time.perf_counter() - t0
        blocks = [b.index for b in solver.case.blocks]
        xs = solver.mg_cases[0].exchange
        print(f"rank {comm.rank}/{comm.world} on {where}: blocks {blocks}, "
              f"{len(solver.step_seconds)} steps in {seconds:.3f} s; "
              f"exchange: gloo with host staging, {xs.calls} swaps at "
              f"level 0", flush=True)
    finally:
        finalize()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
