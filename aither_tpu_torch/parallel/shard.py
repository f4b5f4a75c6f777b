"""Which rank owns which block of a multi-rank run.

Counterpart of ``aither_tpu/parallel/shard.py`` (``make_mesh`` :42,
``block_spec`` :54).  The JAX package shards each block's grid axes over
a device mesh inside one program; the port follows the reference's MPI
model instead (reference: src/parallel.cpp:95-178, one procBlock set per
rank): one process per rank, each owning WHOLE blocks, so every rank runs
the hand-written sweep and viscous kernels on its own blocks unchanged.
"""

from __future__ import annotations


def block_owners(cells, world: int, decomp_rank=None) -> list:
    """The owning rank of every block: ``cells`` the blocks' cell counts,
    ``world`` the number of ranks.  ``decomp_rank`` (the decomposition's
    ``rank`` list of an ``--nproc`` case, ``parallel/decompose.py``) is
    taken as it is when it names exactly ``world`` ranks; otherwise the
    blocks go largest first (ties by index) to the rank holding the fewest
    cells so far (ties by rank).  More ranks than blocks is refused: a
    rank owns whole blocks."""
    nblocks = len(cells)
    if world < 1:
        raise ValueError(f"{world} ranks: a run needs at least one")
    if world > nblocks:
        raise ValueError(
            f"{world} ranks but {nblocks} blocks: each rank owns whole "
            f"blocks, so a run takes at most as many ranks as blocks "
            f"(decompose the grid into more with --nproc)")
    if decomp_rank is not None and sorted(set(decomp_rank)) == list(
            range(world)):
        return [int(r) for r in decomp_rank]
    load = [0] * world
    owners = [0] * nblocks
    for b in sorted(range(nblocks), key=lambda b: (-cells[b], b)):
        r = min(range(world), key=lambda r: (load[r], r))
        owners[b] = r
        load[r] += cells[b]
    return owners
