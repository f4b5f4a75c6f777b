"""PyTorch port, the approximateRoe sweeps' decomposition: every Roe form
of ``csrc/lusgs_sweep.cu`` and ``csrc/blusgs_sweep.cu`` (built with
``-DSWEEP_ROE=1``) stores the old Roe flux F_roe(q_nb | q_cell) and the
viscous radii once per face in a pre-pass (``roe_offdiag.cuh``
store_roe_old_terms), and its lanes evaluate only the new flux of q + du
(in closed form for a calorically perfect gas) against them.  Held on the
CPU in plain PyTorch, without JAX:

1. a plain twin of that pre-pass and of the lanes' combine (mag (new -
   old), then the radii rows): the product assembled from the stored
   terms equals ``implicit.offdiagonal`` per cell and direction bit for
   bit (``torch.equal``), forward and backward, on a small generated
   plate, for calorically perfect SST approximateRoe (the scalar
   product of lusgs and the block vector of blusgs), N2/O2 (the mixture
   path) and Euler (no radii);
2. ``work_doubles``, ``prepass_bytes`` and ``sweep_cost`` of the
   calorically perfect Roe forms at case-A and case-B sized plans, and
   the forms that take the pre-pass; every form runs on the persistent
   CTAs of ``implicit.wavefront_ctas``, the wavefront's one schedule.

The plain functions themselves are held to the JAX package by
``test_torch_roe.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from aither_tpu_torch.cases import (MIXTURES, SMOKE_2D_DIMS,  # noqa: E402
                                    SMOKE_3D_DIMS, write_plate_case)
from aither_tpu_torch.kernels import lusgs_sweep as ls  # noqa: E402
from aither_tpu_torch.solver import implicit as imp  # noqa: E402
from aither_tpu_torch.solver import state as st  # noqa: E402
from aither_tpu_torch.solver.driver import Solver  # noqa: E402
from tests.test_torch_sweep_split import (DIMS, box_plan,  # noqa: E402
                                          old_terms, stored_product)

ROE = dict(inviscid_flux_jacobian="approximateRoe")
DECKS = {"sst": ROE,
         "sst_block": dict(ROE, matrix_solver="blusgs"),
         "n2o2": dict(MIXTURES["n2o2"], **ROE),
         "euler": dict(ROE, equation_set="euler", turbulence_model="none")}


@pytest.fixture(scope="module", params=sorted(DECKS))
def system(request, tmp_path_factory):
    """a deck's Solver on the CPU, its first residual's state and aux
    fields (ghosts filled) and a seeded du of 1e-3 of each equation's
    scale on every padded cell"""
    import numpy as np
    wd = str(tmp_path_factory.mktemp(request.param))
    s = Solver(write_plate_case(wd, *DIMS, **DECKS[request.param]),
               device="cpu", workdir=wd)
    prims, _, _, _, _, auxs = s._residuals(dict(s.prims), s.deck.cfl(0))
    rng = np.random.default_rng(11)
    dus = {}
    for bi, q in prims.items():
        scale = q.abs().amax(dim=(1, 2, 3), keepdim=True)
        dus[bi] = 1e-3 * scale * torch.as_tensor(
            rng.uniform(-1.0, 1.0, tuple(q.shape)))
    return request.param, s, prims, auxs, dus


@pytest.mark.parametrize("forward", [True, False])
def test_stored_roe_terms_product_is_the_offdiagonal(system, forward):
    """the pre-pass's old Roe flux and radii (``old_terms``, per unmasked
    face) and the lanes' new flux of the neighbour's q + du, formed in
    closed form (``state.update_prim_with_cons``), give
    ``implicit.offdiagonal`` bit for bit: the scalar sweep's product and,
    with ``block_matrix``, the block sweep's vector alike"""
    name, s, prims, auxs, dus = system
    phys, cfg = s.phys, s.cfg
    form = ls.sweep_form(phys, cfg)
    block = bool(cfg.get("block_matrix"))
    assert form[4] and not form[5] and ls.prepass_form(form)
    assert block == (name == "sst_block")
    side = "lower" if forward else "upper"
    sign = -1 if forward else 1
    for bi, plan in s.plans.items():
        C = prims[bi].shape[0]
        qf, duf = prims[bi].reshape(C, -1), dus[bi].reshape(C, -1)
        # Euler has no viscous fields
        aux = {k: (None if auxs[bi] is None else auxs[bi][k].reshape(-1))
               for k in ("mu", "mut", "f1")}
        cells, pcells = plan.cells, plan.phys_cells
        mask = plan.mask[side][pcells]
        compared = 0
        for d in range(3):
            m = mask[:, d]
            cell, nb = cells[m], cells[m] + sign * plan.strides[d]
            stat = plan.static[side][pcells[m], d]
            n, mag, dist = stat[:, 0:3].T, stat[:, 3], stat[:, 4]
            kw = {k: None if v is None else v[nb] for k, v in aux.items()}
            kw["dist"] = dist
            old, sr, sr_t = old_terms(phys, cfg, qf[:, nb], qf[:, cell], n,
                                      mag, forward, **kw)
            assert (sr is None) == (name == "euler")
            qu = st.update_prim_with_cons(phys, qf[:, nb], duf[:, nb])
            got = stored_product(phys, cfg, qu, duf[:, nb], qf[:, cell], n,
                                 mag, forward, old, sr, sr_t)
            want = imp.offdiagonal(phys, cfg, qf[:, nb], duf[:, nb], n, mag,
                                   forward, q_diag=qf[:, cell], **kw)
            assert bool(torch.isfinite(want).all())
            assert torch.equal(got, want), (bi, d)
            compared += int(m.sum())
        assert compared > 0


@pytest.mark.parametrize("dims", [SMOKE_2D_DIMS, SMOKE_3D_DIMS],
                         ids=["case_A", "case_B"])
@pytest.mark.parametrize("block", [False, True])
def test_roe_work_space_and_cost(dims, block):
    """a calorically perfect Roe form's work space holds its pre-pass's
    face terms alone (the neq rows of the old flux and, viscous, its radii
    per face of the sweep side: no old energy, no updated state), whose
    traffic, each value written and read once, is ``prepass_bytes``, apart
    from the bound; ``sweep_cost`` stays the function's (both Roe fluxes
    and q + du per contributing face, the function's bytes)"""
    plan = box_plan(*dims)
    g = 2
    plan.padded = tuple(n + 2 * g for n in dims)
    plan.dims = dims
    ni, nj, nk = dims
    ncp = ni * nj * nk
    nfaces = ((ni - 1) * nj * nk + ni * (nj - 1) * nk + ni * nj * (nk - 1))
    forms = {"sst": ls.SST_FORM[:4] + (True, False),
             "euler": (1, 5, False, False, True, False),
             "n2o2": (2, 8, True, False, True, False)}
    values = {"sst": 9, "euler": 5, "n2o2": 10}
    for name, form in forms.items():
        assert ls.face_values(form) == values[name]
        assert ls.work_doubles(form, plan, block) == values[name] * 3 * ncp
        # the thermally perfect scalar form adds its old energies and
        # updated states; a calorically perfect Rusanov form stores its
        # own face terms (scalar) or its neighbour states' conductivity
        # (block, viscous), nothing inviscid
        NI, NJ, NK = plan.padded
        rusanov = form[:4] + (False, False)
        if not block:
            assert ls.work_doubles(form[:5] + (True,), plan) == (
                values[name] * 3 * ncp + ncp + form[1] * NI * NJ * NK)
            assert ls.work_doubles(rusanov, plan) == (
                ls.face_values(rusanov) * 3 * ncp)
        else:
            assert ls.work_doubles(rusanov, plan, True) == (
                NI * NJ * NK if form[2] else 0)
        forward = True
        assert ls.prepass_bytes(plan, forward, form, block) == (
            8 * 2 * values[name] * nfaces)
        nbytes, ops = ls.sweep_cost(plan, forward, False, block, form)
        per_nb = (ls.ROE_NEIGHBOUR_OPS_BY_FORM[form[1:4]] if form[0] == 1
                  else ls.roe_mixture_neighbour_ops(form))
        N = form[0] + 4
        per_cell = (2 * N * N + N + (8 if form[1] == N + 2 else 0)
                    if block else 2 * form[1])
        assert ops == per_nb * nfaces + per_cell * ncp
        # the function's bytes: those of the thermally perfect Roe form,
        # which reads the same inputs
        assert nbytes == ls.sweep_cost(plan, forward, False, block,
                                       form[:5] + (True,), modes=(1,),
                                       ridder_iters=5.0)[0]
        if dims == SMOKE_3D_DIMS:
            break   # one form at case B: each count there is a unique of
            # 1.5M neighbour indices


@pytest.mark.parametrize("block", [False, True])
def test_prepass_forms_and_persistent_ctas(block):
    """every scalar form and every block form but the inviscid
    calorically perfect Rusanov ones takes the pre-pass; every form of
    both sweeps runs on persistent CTAs, the wavefront's one schedule (no
    launch of a CTA a tile is left in the sources); the thermally perfect
    forms that invert q + du (all but the block Rusanov ones) take the
    stage; the persistent CTAs of the case-B block
    (``implicit.wavefront_ctas``) are fewer than its tiles"""
    import os
    for roe in (False, True):
        for tp in (False, True):
            for viscous_form in (ls.SST_FORM[:4],
                                 (1, 5, False, False)):
                form = viscous_form + (roe, tp)
                assert ls.prepass_form(form, block) == (
                    not block or roe or tp or form[2])
                assert ls.staged_form(form, block) == (
                    tp and (roe or not block))
    csrc = os.path.join(os.path.dirname(ls.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "sweep_wavefront.cuh")) as f:
        header = f.read()
    assert "kernel<<<sc.ctas, threads, 0, st>>>(args..., sc);" in header
    for name in ("sweep_wavefront.cuh", "lusgs_sweep.cu", "blusgs_sweep.cu"):
        with open(os.path.join(csrc, name)) as f:
            assert "PERSISTENT" not in f.read(), name
    tile = imp.sweep_tile(SMOKE_3D_DIMS)
    ntiles = len(imp.tile_table(SMOKE_3D_DIMS, tile))
    assert 0 < imp.wavefront_ctas(SMOKE_3D_DIMS, tile) < ntiles
