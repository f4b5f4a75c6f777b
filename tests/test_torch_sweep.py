"""PyTorch port, LU-SGS sweep parity: one plain forward + backward sweep
pair in physical layout against aither_tpu's lusgs_forward_group /
lusgs_backward_group, whose hyperplane recurrence runs through the Pallas
sweep kernel (pallas_sweep.sweep) in interpret mode — without the lagged
opposite-side term (variant a) and with it (variant b, ``with_extra``: the
port passes ``implicit.offdiag_sum`` of the du each sweep starts from).

Both sides get identical numpy inputs (the port's linear system of the
perturbed plate, plus random du in the ghosts so connection ghosts feed
the sweep).  Tolerance 1e-10 against each equation's scale: the
recurrence carries the off-diagonal flux differences (which cancel ~2
digits) through ~20 dependent planes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (jax_solver, perturbed_prims,  # noqa: E402
                                rel_err, torch_solver, write_case)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

TOL = 1e-10


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """(jax solver, torch solver, numpy sweep inputs by block)."""
    wd = tmp_path_factory.mktemp("plate")
    path = write_case(wd)
    js, ts = jax_solver(path, wd), torch_solver(path, wd)
    ts.set_state(perturbed_prims(ts.case.blocks))
    prims, res, sr, dg, dts, auxs = ts._residuals(dict(ts.prims),
                                                  ts.deck.cfl(0))
    inv_diag, _, bs, _ = ts._setup_linear(prims, res, sr, dg, dts, auxs,
                                          ts.cons_n)
    rng = np.random.default_rng(5)
    inputs = {}
    for b in ts.case.blocks:
        bi = b.index
        inputs[bi] = dict(
            prim=prims[bi].numpy(), b=bs[bi].numpy(),
            inv_f=inv_diag[bi][0].numpy(), inv_t=inv_diag[bi][1].numpy(),
            du=1e-4 * rng.standard_normal((ts.phys.neq,) + b.shape),
            **{k: auxs[bi][k].numpy() for k in ("mu", "mut", "f1")})
    return js, ts, inputs


def _jax_sweeps(js, inputs, with_extra=False):
    """forward then backward group sweep over both (same-shape) blocks."""
    from aither_tpu.solver import implicit as jim
    blocks = js.case.blocks
    ctxs = [jim.build_implicit_context(b) for b in blocks]

    def run(arrs):
        items = []
        for b, ctx in zip(blocks, ctxs):
            a = arrs[b.index]
            items.append(dict(
                block=b, ctx=ctx, prim=a["prim"], du=a["du"],
                b=jim.skew_from_physical(ctx, a["b"]),
                inv_f=jim.skew_from_physical(ctx, a["inv_f"]),
                inv_t=jim.skew_from_physical(ctx, a["inv_t"]),
                aux={k: a[k] for k in ("mu", "mut", "f1")}))
        fwd = jim.lusgs_forward_group(js.phys, js.cfg, items, with_extra)
        for it, du in zip(items, fwd):
            it["du"] = du
        bwd = jim.lusgs_backward_group(js.phys, js.cfg, items, with_extra)
        return fwd, bwd

    from aither_tpu.solver import pallas_sweep as ps
    assert ps.use_pallas(js.cfg, jnp.float64, js.phys)   # kernel path
    arrs = {bi: {k: jnp.asarray(v) for k, v in a.items()}
            for bi, a in inputs.items()}
    fwd, bwd = jax.jit(run)(arrs)
    return ({b.index: np.asarray(f) for b, f in zip(blocks, fwd)},
            {b.index: np.asarray(f) for b, f in zip(blocks, bwd)})


def test_plain_sweep_pair_matches_pallas_kernel(system):
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    js, ts, inputs = system
    want_f, want_b = _jax_sweeps(js, inputs)
    launches = ls.LAUNCHES.count
    for b in ts.case.blocks:
        bi = b.index
        a = {k: torch.as_tensor(v.copy()) for k, v in inputs[bi].items()}
        aux = {k: a[k] for k in ("mu", "mut", "f1")}
        plan = ts.plans[bi]
        du = ls.forward(ts.phys, ts.cfg, plan, a["prim"], a["du"], a["b"],
                        a["inv_f"], a["inv_t"], aux)
        for e in range(ts.phys.neq):
            err = rel_err(du[e], want_f[bi][e])
            assert err < TOL, ("forward", bi, e, err)
        du = ls.backward(ts.phys, ts.cfg, plan, a["prim"], du, a["b"],
                         a["inv_f"], a["inv_t"], aux)
        for e in range(ts.phys.neq):
            err = rel_err(du[e], want_b[bi][e])
            assert err < TOL, ("backward", bi, e, err)
    # CPU tensors take the plain version: no kernel launch
    assert ls.LAUNCHES.count == launches


def test_plain_sweep_pair_with_extra_matches_pallas_kernel(system):
    """variant (b): the lagged upper sum in the forward sweep, the lagged
    lower sum of the forward result in the backward sweep"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver import implicit as tim
    js, ts, inputs = system
    want_f, want_b = _jax_sweeps(js, inputs, with_extra=True)
    for b in ts.case.blocks:
        bi = b.index
        a = {k: torch.as_tensor(v.copy()) for k, v in inputs[bi].items()}
        aux = {k: a[k] for k in ("mu", "mut", "f1")}
        plan = ts.plans[bi]
        extra = tim.offdiag_sum(ts.phys, ts.cfg, b, a["prim"], a["du"],
                                "upper", aux)
        du = ls.forward(ts.phys, ts.cfg, plan, a["prim"], a["du"], a["b"],
                        a["inv_f"], a["inv_t"], aux, extra=extra)
        for e in range(ts.phys.neq):
            err = rel_err(du[e], want_f[bi][e])
            assert err < TOL, ("forward", bi, e, err)
        extra = tim.offdiag_sum(ts.phys, ts.cfg, b, a["prim"], du, "lower",
                                aux)
        du = ls.backward(ts.phys, ts.cfg, plan, a["prim"], du, a["b"],
                         a["inv_f"], a["inv_t"], aux, extra=extra)
        for e in range(ts.phys.neq):
            err = rel_err(du[e], want_b[bi][e])
            assert err < TOL, ("backward", bi, e, err)


def test_sweep_plan_covers_every_cell_once(system):
    _, ts, _ = system
    for b in ts.case.blocks:
        plan = ts.plans[b.index]
        ni, nj, nk = plan.dims
        assert plan.nplanes == ni + nj + nk - 2
        pc = plan.phys_cells.numpy()
        assert np.array_equal(np.sort(pc), np.arange(ni * nj * nk))
        # each plane holds exactly the cells with i+j+k == p
        i, rem = np.divmod(pc, nj * nk)
        j, k = np.divmod(rem, nk)
        ptr = plan.plane_ptr
        for p in range(plan.nplanes):
            sl = slice(ptr[p], ptr[p + 1])
            assert np.all(i[sl] + j[sl] + k[sl] == p)


def test_wrapper_rejects_other_devices(system):
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    _, ts, inputs = system
    b = ts.case.blocks[0]
    a = {k: torch.as_tensor(v.copy()).to("meta")
         for k, v in inputs[b.index].items()}
    with pytest.raises(ValueError, match="meta"):
        ls.forward(ts.phys, ts.cfg, ts.plans[b.index], a["prim"], a["du"],
                   a["b"], a["inv_f"], a["inv_t"],
                   {k: a[k] for k in ("mu", "mut", "f1")})
