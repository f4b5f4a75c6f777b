"""PyTorch port, the block-matrix LU-SGS path (``matrixSolver: blusgs``)
against aither_tpu on the generated two-block SST plate:

1. the block Jacobians (``solver/block_jac.py``) and the block pieces of
   ``solver/implicit.py`` against their JAX counterparts on random states,
   normals, areas, distances, viscosities and gradients, both sides of a
   face (rtol 1e-12, atol 1e-14: the same expressions in float64, the
   einsums summed in another order), and the channel forms the sweep
   kernel evaluates against the assembled forms inside the port;
2. the residual's block outputs (inviscid Rusanov + viscous TSL + SST
   source block diagonals, the padded velocity gradient) and the block
   diagonal with its inverse (1e-10 of each field's scale, as
   test_torch_residual);
3. one plain forward + backward block sweep pair against JAX
   ``lusgs_forward_group`` / ``lusgs_backward_group`` with
   ``block_matrix`` set, whose recurrence runs through the Pallas sweep
   kernel in interpret mode, without and with the lagged term (1e-10 per
   equation, as test_torch_sweep);
4. one full blusgs iteration against the JAX Solver (Pallas sweep in
   interpret mode; its fused viscous march is off for block matrices, as
   the port's K2 is) for ``matrixSweeps`` 1 and 2 (prims 1e-10, matrix
   residual 1e-9 relative), and a 5-iteration raw L2 history at
   ``matrixSweeps: 1`` (1e-8, as test_torch_slice);
5. routing: CPU tensors launch no kernel, a meta tensor is refused, the
   deck check admits blusgs and still refuses bdplur, the block residual
   takes the plain viscous residual (not the fused kernel's wrapper), the
   CLI runs a blusgs deck on the CPU, and the import scan of
   test_torch_host reads the block modules.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from aither_tpu_torch.cases import TEST_DIMS, write_plate_case  # noqa: E402
from tests.torch_parity import (jax_solver, np_, perturbed_prims,  # noqa: E402
                                rel_err, torch_solver)
from tests.torch_parity import quick_jax_module  # noqa: E402,F401 (autouse)

TOL = 1e-10
ITERATIONS = 5
SHAPE = (4, 5)


def _pair(tmp_path_factory, matrix_sweeps=1):
    wd = tmp_path_factory.mktemp("blusgs")
    path = write_plate_case(str(wd), *TEST_DIMS, matrix_sweeps=matrix_sweeps,
                            matrix_solver="blusgs")
    js, ts = jax_solver(path, wd), torch_solver(path, wd)
    assert js.cfg["block_matrix"] and ts.cfg["block_matrix"]
    prims = perturbed_prims(js.case.blocks)
    js.prims = {b: jnp.asarray(v) for b, v in prims.items()}
    js.cons_n = js.store_old_solution()
    ts.set_state(prims, {b: np_(v) for b, v in js.cons_n.items()})
    return js, ts


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _pair(tmp_path_factory)


@pytest.fixture(scope="module")
def pair_lagged(tmp_path_factory):
    return _pair(tmp_path_factory, matrix_sweeps=2)


# ---------------------------------------------------------------------------
# 1. block Jacobians on random inputs


def _random_inputs(phys, seed):
    """numpy face inputs: state, du, unit normal, area, distance, mu, mut,
    f1, velocity gradient, volume, beta, and a random 5x5 / 2x2 pair."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.5, 1.5, (phys.neq,) + SHAPE)
    q[phys.mx:phys.ie] = rng.uniform(-0.3, 0.3, (3,) + SHAPE)
    n = rng.normal(size=(3,) + SHAPE)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    return dict(
        q=q, du=rng.normal(size=(phys.neq,) + SHAPE), n=n,
        mag=rng.uniform(0.5, 2.0, SHAPE), dist=rng.uniform(0.1, 1.0, SHAPE),
        mu=rng.uniform(0.5, 1.5, SHAPE), mut=rng.uniform(0.0, 2.0, SHAPE),
        f1=rng.uniform(0.0, 1.0, SHAPE),
        vgrad=rng.normal(size=(3, 3) + SHAPE),
        vol=rng.uniform(0.5, 2.0, SHAPE), beta=rng.uniform(0.07, 0.09, SHAPE),
        mat_f=rng.normal(size=SHAPE + (5, 5)) + 4.0 * np.eye(5),
        mat_t=rng.normal(size=SHAPE + (2, 2)) + 4.0 * np.eye(2))


def _cfg(model):
    return dict(viscous=True, turb_model=model, block_matrix=True,
                diffusion="none")


def _both(js, ts, name, model, positive, inputs):
    """(port result, JAX result) of one function on the same inputs."""
    from aither_tpu.solver import block_jac as jbj
    from aither_tpu.solver import implicit as jim
    from aither_tpu_torch.solver import block_jac as tbj
    from aither_tpu_torch.solver import implicit as tim
    cfg = _cfg(model)
    out = []
    for pkg, phys, conv in ((tbj, ts.phys, torch.as_tensor),
                            (jbj, js.phys, jnp.asarray)):
        imp = tim if pkg is tbj else jim
        a = {k: conv(v) for k, v in inputs.items()}
        q, du, n, mag = a["q"], a["du"], a["n"], a["mag"]
        visc = (a["mu"], a["mut"], a["f1"], n, mag, a["dist"], a["vgrad"])
        kw = dict(dist=a["dist"], mu=a["mu"], mut=a["mut"], f1=a["f1"],
                  vgrad=a["vgrad"])
        if name == "inv_flux_jacobian":
            r = pkg.inv_flux_jacobian(phys, q, n, mag)
        elif name == "rusanov_flux_jacobian":
            r = pkg.rusanov_flux_jacobian(phys, q, n, mag, positive)
        elif name == "rusanov_offdiag_matvec":
            r = pkg.rusanov_offdiag_matvec(phys, q, n, mag, positive, du)
        elif name == "del_prim_del_cons":
            r = pkg.del_prim_del_cons(phys, q)
        elif name == "approx_tsl_jacobian":
            r = pkg.approx_tsl_jacobian(phys, cfg, q, *visc, left=positive)
        elif name == "tsl_offdiag_matvec":
            r = pkg.tsl_offdiag_matvec(phys, cfg, q, *visc, positive, du)
        elif name == "turb_src_jacobian":
            r = pkg.turb_src_jacobian(phys, cfg, q, a["vol"], a["beta"], 0.7)
        elif name == "rows_matvec":
            rows = [[a["mat_f"][..., i, j] for j in range(5)]
                    for i in range(5)]
            r = pkg.rows_matvec(rows, du[:5], scale=mag)
        elif name == "block_matvec":
            r = pkg.block_matvec(a["mat_f"], a["mat_t"], du, phys)
        elif name == "block_inverse":
            r = pkg.block_inverse(a["mat_f"], a["mat_t"])
        elif name == "offdiagonal":                  # the block dispatch
            r = imp.offdiagonal(phys, cfg, q, du, n, mag, positive, **kw)
        elif name == "offdiagonal_block_channels":
            r = imp.offdiagonal_block_channels(phys, cfg, q, du, n, mag,
                                               positive, **kw)
        elif name == "diag_mult_channels":
            ch_f = conv(np.moveaxis(inputs["mat_f"].reshape(SHAPE + (25,)),
                                    -1, 0).copy())
            ch_t = conv(np.moveaxis(inputs["mat_t"].reshape(SHAPE + (4,)),
                                    -1, 0).copy())
            r = imp.diag_mult_channels(phys, ch_f, ch_t, du)
        elif pkg is tbj:         # the port applies the block diagonal
            r = imp.diag_mult_channels(                # as channels only
                phys, tim.blk_to_channels(a["mat_f"]),
                tim.blk_to_channels(a["mat_t"]), du)
        else:                                        # block diag_mult
            r = imp.diag_mult(phys, a["mat_f"], a["mat_t"], du)
        out.append(r if isinstance(r, tuple) else (r,))
    return out


FUNCTIONS = ("inv_flux_jacobian", "rusanov_flux_jacobian",
             "rusanov_offdiag_matvec", "del_prim_del_cons",
             "approx_tsl_jacobian", "tsl_offdiag_matvec",
             "turb_src_jacobian", "rows_matvec", "block_matvec",
             "block_inverse", "offdiagonal",
             "offdiagonal_block_channels", "diag_mult_channels", "diag_mult")


@pytest.mark.parametrize("name", FUNCTIONS)
def test_block_jacobians_match_jax(pair, name):
    js, ts = pair
    models = (("sst2003", "kOmegaWilcox2006")
              if name in ("approx_tsl_jacobian", "tsl_offdiag_matvec",
                          "turb_src_jacobian") else ("sst2003",))
    for seed, model in enumerate(models):
        inputs = _random_inputs(ts.phys, seed)
        for positive in (True, False):
            got, want = _both(js, ts, name, model, positive, inputs)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(np_(g), np_(w), rtol=1e-12,
                                           atol=1e-14,
                                           err_msg=f"{name} {model} "
                                                   f"{positive}")


def test_channel_forms_match_assembled(pair):
    """inside the port: the row-matvec forms that the off-diagonal, the
    sweeps and the kernel evaluate equal the assembled block Jacobians
    (those the block diagonal is built from) times du"""
    from aither_tpu_torch.solver import block_jac as bj
    from aither_tpu_torch.solver import implicit as imp
    _, ts = pair
    phys = ts.phys
    a = {k: torch.as_tensor(v)
         for k, v in _random_inputs(phys, 11).items()}
    cfg = _cfg("sst2003")
    kw = dict(dist=a["dist"], mu=a["mu"], mut=a["mut"], f1=a["f1"],
              vgrad=a["vgrad"])
    for positive in (True, False):
        jf, jt = bj.rusanov_flux_jacobian(phys, a["q"], a["n"], a["mag"],
                                          positive)
        vf, vt = bj.approx_tsl_jacobian(phys, cfg, a["q"], a["mu"],
                                        a["mut"], a["f1"], a["n"], a["mag"],
                                        a["dist"], a["vgrad"], positive)
        s = -1.0 if positive else 1.0
        pairs = [(bj.rusanov_offdiag_matvec(phys, a["q"], a["n"], a["mag"],
                                            positive, a["du"]),
                  bj.block_matvec(jf, jt, a["du"], phys)),
                 (torch.cat(bj.tsl_offdiag_matvec(
                     phys, cfg, a["q"], a["mu"], a["mut"], a["f1"], a["n"],
                     a["mag"], a["dist"], a["vgrad"], positive, a["du"])),
                  bj.block_matvec(vf, vt, a["du"], phys)),
                 (imp.offdiagonal(phys, cfg, a["q"], a["du"], a["n"],
                                  a["mag"], positive, **kw),
                  bj.block_matvec(jf + s * vf, jt + s * vt, a["du"], phys))]
        for got, want in pairs:
            np.testing.assert_allclose(np_(got), np_(want), rtol=1e-11,
                                       atol=1e-13)
    ch = (imp.blk_to_channels(a["mat_f"]), imp.blk_to_channels(a["mat_t"]))
    assert ch[0].shape == (25,) + SHAPE and ch[0].is_contiguous()
    np.testing.assert_allclose(
        np_(imp.diag_mult_channels(phys, *ch, a["du"])),
        np_(bj.block_matvec(a["mat_f"], a["mat_t"], a["du"], phys)),
        rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# 2. the residual's block outputs and the block diagonal


def test_residual_block_outputs(pair):
    from aither_tpu.solver import implicit as jim
    from aither_tpu.solver import step as jstep
    from aither_tpu_torch.solver import implicit as tim
    from aither_tpu_torch.solver import step as tstep
    js, ts = pair
    cfl = ts.deck.cfl(0)

    def jax_side(prims):
        prims = jstep.apply_all_bcs(js.phys, js.case, prims)
        out = {}
        for b in js.case.blocks:
            (_, sr_f, sr_t, _, _, _, _, aux) = jstep.full_residual(
                js.phys, js.cfg, b, prims[b.index], need_aux=False)
            sr_max = jnp.maximum(sr_f, sr_t)
            dt = jstep.local_dt(js.cfg, b.geom, sr_max, b.g,
                                (b.ni, b.nj, b.nk), cfl)
            a, inv = jim.build_block_diagonal(
                js.phys, b, js.cfg, aux["diag_flow_blk"],
                aux["diag_turb_blk"], sr_max, dt)
            out[b.index] = dict(diag_flow_blk=aux["diag_flow_blk"],
                                diag_turb_blk=aux["diag_turb_blk"],
                                vgrad=aux["vgrad"], a_flow=a[0],
                                a_turb=a[1], inv_flow=inv[0],
                                inv_turb=inv[1])
        return out

    want = jax.jit(jax_side)(js.prims)
    prims = tstep.apply_all_bcs(ts.phys, ts.case, dict(ts.prims))
    for b in ts.case.blocks:
        (_, sr_f, sr_t, _, _, _, _, aux) = tstep.full_residual(
            ts.phys, ts.cfg, b, prims[b.index])
        sr_max = torch.maximum(sr_f, sr_t)
        dt = tstep.local_dt(ts.cfg, b.geom, sr_max, b.g, (b.ni, b.nj, b.nk),
                            cfl)
        a, inv = tim.build_block_diagonal(
            ts.phys, b, ts.cfg, aux["diag_flow_blk"], aux["diag_turb_blk"],
            sr_max, dt)
        got = dict(diag_flow_blk=aux["diag_flow_blk"],
                   diag_turb_blk=aux["diag_turb_blk"], vgrad=aux["vgrad"],
                   a_flow=a[0], a_turb=a[1], inv_flow=inv[0],
                   inv_turb=inv[1])
        for key, w in want[b.index].items():
            assert got[key].shape == w.shape, key
            assert rel_err(got[key], w) < TOL, (b.index, key)


# ---------------------------------------------------------------------------
# 3. the block sweep pair


@pytest.fixture(scope="module")
def system(pair):
    """numpy sweep inputs by block: the port's linear system of the
    perturbed plate (the inverse blocks as channels, as the sweeps take
    them), random du in the ghosts so connection ghosts feed the sweep."""
    _, ts = pair
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
            **{k: auxs[bi][k].numpy() for k in ("mu", "mut", "f1", "vgrad")})
    return inputs


def _jax_block_sweeps(js, inputs, with_extra):
    """forward then backward group sweep over both blocks, block matrices
    on the Pallas kernel (interpret mode)"""
    from aither_tpu.solver import implicit as jim
    from aither_tpu.solver import pallas_sweep as ps
    blocks = js.case.blocks
    ctxs = [jim.build_implicit_context(b) for b in blocks]

    def assembled(ch):
        """(n*n, ni, nj, nk) channels -> (ni, nj, nk, n, n) blocks"""
        n = int(round(ch.shape[0] ** 0.5))
        return jnp.moveaxis(ch, 0, -1).reshape(ch.shape[1:] + (n, n))

    def run(arrs):
        items = []
        for b, ctx in zip(blocks, ctxs):
            a = arrs[b.index]
            items.append(dict(
                block=b, ctx=ctx, prim=a["prim"], du=a["du"],
                b=jim.skew_from_physical(ctx, a["b"]),
                inv_f=jim.skew_from_physical_blk(ctx, assembled(a["inv_f"])),
                inv_t=jim.skew_from_physical_blk(ctx, assembled(a["inv_t"])),
                aux={k: a[k] for k in ("mu", "mut", "f1", "vgrad")}))
        fwd = jim.lusgs_forward_group(js.phys, js.cfg, items, with_extra)
        for it, du in zip(items, fwd):
            it["du"] = du
        bwd = jim.lusgs_backward_group(js.phys, js.cfg, items, with_extra)
        return fwd, bwd

    assert js.cfg["block_matrix"]
    assert ps.use_pallas(js.cfg, jnp.float64, js.phys)   # kernel path
    arrs = {bi: {k: jnp.asarray(v) for k, v in a.items()}
            for bi, a in inputs.items()}
    fwd, bwd = jax.jit(run)(arrs)
    return ({b.index: np.asarray(f) for b, f in zip(blocks, fwd)},
            {b.index: np.asarray(f) for b, f in zip(blocks, bwd)})


@pytest.mark.parametrize("with_extra", [False, True])
def test_plain_block_sweep_pair_matches_pallas_kernel(pair, system,
                                                      with_extra):
    """variant (c), and (c)+(b): the lagged upper sum in the forward sweep,
    the lagged lower sum of the forward result in the backward sweep; CPU
    tensors take the plain version and launch no kernel"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    from aither_tpu_torch.solver import implicit as tim
    js, ts = pair
    want_f, want_b = _jax_block_sweeps(js, system, with_extra)
    launches = (ls.LAUNCHES.count, ls.BLOCK_LAUNCHES.count)
    for b in ts.case.blocks:
        bi = b.index
        a = {k: torch.as_tensor(v.copy()) for k, v in system[bi].items()}
        aux = {k: a[k] for k in ("mu", "mut", "f1", "vgrad")}
        inv = (a["inv_f"], a["inv_t"])
        plan = ts.plans[bi]
        extra = (tim.offdiag_sum(ts.phys, ts.cfg, b, a["prim"], a["du"],
                                 "upper", aux) if with_extra else None)
        du = ls.forward(ts.phys, ts.cfg, plan, a["prim"], a["du"], a["b"],
                        *inv, aux, extra=extra)
        for e in range(ts.phys.neq):
            err = rel_err(du[e], want_f[bi][e])
            assert err < TOL, ("forward", bi, e, err)
        extra = (tim.offdiag_sum(ts.phys, ts.cfg, b, a["prim"], du, "lower",
                                 aux) if with_extra else None)
        du = ls.backward(ts.phys, ts.cfg, plan, a["prim"], du, a["b"], *inv,
                         aux, extra=extra)
        for e in range(ts.phys.neq):
            err = rel_err(du[e], want_b[bi][e])
            assert err < TOL, ("backward", bi, e, err)
    assert (ls.LAUNCHES.count, ls.BLOCK_LAUNCHES.count) == launches


def test_block_sweep_refuses_meta_tensors(pair, system):
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    _, ts = pair
    b = ts.case.blocks[0]
    a = {k: torch.as_tensor(v).to("meta") for k, v in system[0].items()}
    aux = {k: a[k] for k in ("mu", "mut", "f1", "vgrad")}
    inv = (a["inv_f"], a["inv_t"])
    launches = ls.BLOCK_LAUNCHES.count
    for fn in (ls.forward, ls.backward):
        with pytest.raises(ValueError, match="meta"):
            fn(ts.phys, ts.cfg, ts.plans[b.index], a["prim"], a["du"],
               a["b"], *inv, aux)
    assert ls.BLOCK_LAUNCHES.count == launches


def test_block_kernel_operand_guards(pair, system):
    """the wrapper's checks reject scalar inverses and a missing vgrad
    shape for the block solver before anything is launched"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    _, ts = pair
    b = ts.case.blocks[0]
    a = {k: torch.as_tensor(v) for k, v in system[0].items()}
    aux = {k: a[k] for k in ("mu", "mut", "f1", "vgrad")}
    inv = (a["inv_f"], a["inv_t"])
    args = (ts.phys, ts.cfg, ts.plans[b.index], a["prim"], a["du"], a["b"])
    ls._check_operands(*args, *inv, aux, None)
    with pytest.raises(ValueError, match="inv_f"):
        ls._check_operands(*args, inv[0][0], inv[1], aux, None)
    with pytest.raises(ValueError, match="vgrad"):
        ls._check_operands(*args, *inv, dict(aux, vgrad=a["mu"]), None)


@pytest.mark.parametrize("forward", [True, False])
def test_sweep_cost_reads_each_neighbour_once(pair, forward):
    """the bound's reads of the padded fields: each distinct neighbour
    across an unmasked face once, counted here cell by cell; the ghosts
    among them lie in the first ghost layer, never in an edge, a corner
    or the second layer, and are fewer than the padded ghost cells"""
    from aither_tpu_torch.kernels import lusgs_sweep as ls
    _, ts = pair
    for b in ts.case.blocks:
        plan = ts.plans[b.index]
        mask = plan.mask["lower" if forward else "upper"][
            plan.phys_cells].numpy()
        cells = plan.cells.numpy()
        want = set()
        for c, m in zip(cells.tolist(), mask.tolist()):
            for d in range(3):
                if m[d]:
                    want.add(c - plan.strides[d] if forward
                             else c + plan.strides[d])
        ghosts = want - set(cells.tolist())
        assert ls.neighbour_reads(plan, forward) == (len(want), len(ghosts))
        g, dims = plan.g, np.array(plan.dims)
        for c in ghosts:
            ijk = np.array(np.unravel_index(c, plan.padded)) - g
            outside = (ijk < 0) | (ijk >= dims)
            assert outside.sum() == 1
            assert np.all((ijk >= -1) & (ijk <= dims))
        assert len(ghosts) < np.prod(plan.padded) - len(cells)
        for block in (False, True):
            for extra in (False, True):
                nbytes, ops = ls.sweep_cost(plan, forward, extra, block)
                assert 0 < nbytes and 0 < ops


# ---------------------------------------------------------------------------
# 4. whole iterations


def _jax_step(js, nn):
    cfl = jnp.asarray(js.deck.cfl(nn), js.case.dtype)
    prims, l2, linfs, mr, js.bc_aux = js._iterate(
        js.prims, js.cons_n, js.cons_nm1, cfl, 0, bc_aux=js.bc_aux)
    return prims, np.asarray(l2), float(mr)


def _check_one_iteration(js, ts):
    want_prims, want_l2, want_mr = _jax_step(js, 0)
    got_prims, got_l2, _, got_mr, _ = ts._iteration(dict(ts.prims), ts.cons_n,
                                                 ts.deck.cfl(0))
    for b in ts.case.blocks:
        g = b.g
        for e in range(ts.phys.neq):
            w = np_(want_prims[b.index])[e, g:g + b.ni, g:g + b.nj,
                                         g:g + b.nk]
            t = got_prims[b.index][b.interior][e]
            assert rel_err(t, w) < TOL, (b.index, e)
    np.testing.assert_allclose(np_(got_l2), want_l2, rtol=TOL)
    assert float(got_mr) == pytest.approx(want_mr, rel=1e-9)


def test_one_iteration(pair):
    _check_one_iteration(*pair)


def test_one_iteration_lagged_sweeps(pair_lagged):
    js, ts = pair_lagged
    assert js.cfg["matrix_sweeps"] == ts.cfg["matrix_sweeps"] == 2
    _check_one_iteration(js, ts)


def test_residual_history(pair):
    js, ts = pair
    want = []
    for nn in range(ITERATIONS):
        js.cons_n = js.store_old_solution()
        js.prims, l2, _ = _jax_step(js, nn)
        want.append(np.sqrt(l2))
    ts.run(iterations=ITERATIONS)
    got = np.asarray(ts.l2_history)
    assert got.shape == (ITERATIONS, ts.phys.neq)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-8)


# ---------------------------------------------------------------------------
# 5. routing


def test_deck_check_admits_blusgs_and_bdplur(tmp_path):
    """both block solvers pass the deck check; bdplur builds a CPU solver
    with the block matrix and no sweep plans (it sweeps nothing)"""
    from aither_tpu_torch.io.deck import parse_deck
    from aither_tpu_torch.solver.driver import Solver, check_supported
    path = write_plate_case(str(tmp_path), 4, 3, 2, matrix_solver="blusgs")
    check_supported(parse_deck(path).finalize())
    path = write_plate_case(str(tmp_path), 4, 3, 2, matrix_solver="bdplur")
    check_supported(parse_deck(path).finalize())
    ts = Solver(path, device="cpu", workdir=str(tmp_path))
    assert ts.cfg["block_matrix"] and not ts.sweeps and not ts.plans


def test_block_residual_takes_the_plain_viscous_residual(pair, monkeypatch):
    """blusgs routes around the fused viscous kernel (K2), as the JAX
    package's use_march does for block matrices; lusgs goes through it"""
    from aither_tpu_torch.kernels import viscous_march as vm
    from aither_tpu_torch.solver import step as tstep
    _, ts = pair
    prims = tstep.apply_all_bcs(ts.phys, ts.case, dict(ts.prims))
    b = ts.case.blocks[0]

    def refuse(*args, **kw):
        raise AssertionError("fused viscous kernel wrapper called")

    monkeypatch.setattr(vm, "viscous_residual", refuse)
    aux = tstep.full_residual(ts.phys, ts.cfg, b, prims[b.index])[-1]
    assert aux["diag_flow_blk"].shape == (b.ni, b.nj, b.nk, 5, 5)
    with pytest.raises(AssertionError, match="fused viscous"):
        tstep.full_residual(ts.phys, dict(ts.cfg, block_matrix=False), b,
                            prims[b.index])


def test_cli_runs_a_blusgs_deck_on_the_cpu(tmp_path, monkeypatch):
    from aither_tpu_torch.main import main
    path = write_plate_case(str(tmp_path), 4, 3, 2, matrix_solver="blusgs")
    monkeypatch.chdir(tmp_path)
    assert main([path, "--device", "cpu", "--iterations", "2",
                 "--no-files"]) == 0
    with open(tmp_path / "plate.resid") as f:
        rows = [ln for ln in f if ln.strip()]
    assert len(rows) == 3          # header + one row per iteration


def test_import_scan_covers_the_block_modules():
    """tests/test_torch_host.py's scan for jax / aither_tpu imports reads
    the block Jacobians and the sweep wrapper that launches the block
    kernel"""
    from tests.test_torch_host import _port_sources
    scanned = {p.replace("\\", "/") for p in _port_sources()}
    for rel in ("aither_tpu_torch/solver/block_jac.py",
                "aither_tpu_torch/kernels/lusgs_sweep.py"):
        assert any(p.endswith(rel) for p in scanned), rel


def test_default_deck_unchanged_and_blusgs_field(tmp_path):
    """the deck template's matrixSolver line is a field: the default deck
    still says lusgs, and only that line differs for blusgs"""
    a = write_plate_case(str(tmp_path / "a"), 4, 3, 2)
    b = write_plate_case(str(tmp_path / "b"), 4, 3, 2, matrix_solver="blusgs")
    with open(a) as fa, open(b) as fb:
        la, lb = fa.read().splitlines(), fb.read().splitlines()
    diff = [(x, y) for x, y in zip(la, lb) if x != y]
    assert len(la) == len(lb)
    assert diff == [("matrixSolver: lusgs", "matrixSolver: blusgs")]
