"""PyTorch port, the fused viscous residual (K2): the port's
``kernels.viscous_march.viscous_residual`` on the CPU (its plain version)
against aither_tpu's Pallas ``viscous_residual_march`` in interpret mode,
on the perturbed generated plate in 3-D (2 x 12x8x3) and in 2-D (nk = 1,
where the k faces read the slipWall ghosts), with the full return tuple
and every SST cell average; and the wrapper's refusals.

Tolerance: rtol 1e-9, atol 1e-13, the bound the JAX package holds its own
march to (tests/test_pallas_residual.py): both sides evaluate the same
float64 expressions; the sums over the six faces and the face-CV
gradients' cancellation carry the roundoff.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (assert_close, jax_solver,  # noqa: E402
                                perturbed_prims, torch_solver, write_case)

RTOL, ATOL = 1e-9, 1e-13
NAMES = ("resid", "sr_flow", "sr_turb", "diag_flow", "diag_turb")
CELLAVG = ("vel", "tke", "omega", "mut", "f1", "f2")


def _inputs(ts, prims):
    """the port's viscous residual inputs of every block: prim after the
    full and the viscous ghost fill, temperature and viscosity"""
    from aither_tpu_torch.solver import step as tstep
    phys = ts.phys
    filled = tstep.apply_all_bcs(phys, ts.case,
                                 {b: torch.as_tensor(v)
                                  for b, v in prims.items()})
    out = {}
    for b in ts.case.blocks:
        prim = tstep.apply_boundary_ghosts(phys, b, filled[b.index],
                                           viscous_pass=True)
        prim = tstep.apply_edge_ghosts(phys, b, prim, viscous_pass=True)
        t_all = phys.temperature(prim[phys.ie], prim[:phys.ns])
        out[b.index] = (prim, t_all, phys.viscosity(t_all))
    return out


@pytest.fixture(scope="module", params=[(12, 8, 3), (12, 8, 1)],
                ids=["3d", "2d"])
def pair(request, tmp_path_factory):
    wd = tmp_path_factory.mktemp("plate")
    path = write_case(wd, request.param)
    js, ts = jax_solver(path, wd), torch_solver(path, wd)
    return js, ts, _inputs(ts, perturbed_prims(ts.case.blocks))


def test_plain_matches_pallas_march(pair):
    from aither_tpu.solver import pallas_residual as pres
    from aither_tpu_torch.kernels import viscous_march as vm
    js, ts, inputs = pair
    launches = vm.LAUNCHES.count
    for jb, tb in zip(js.case.blocks, ts.case.blocks):
        prim, t_all, mu_all = inputs[tb.index]
        assert pres.use_march(js.phys, js.cfg, jb, js.case.dtype,
                              for_prepack=True)
        pres.ensure_static(js.phys, js.cfg, jb, js.case.dtype)
        want = pres.viscous_residual_march(
            js.phys, js.cfg, jb, jnp.asarray(prim.numpy()),
            jnp.asarray(t_all.numpy()), jnp.asarray(mu_all.numpy()))
        got = vm.viscous_residual(ts.phys, ts.cfg, tb, prim, t_all, mu_all)
        assert len(got) == 6
        for i, name in enumerate(NAMES):
            assert_close(got[i], want[i], RTOL, ATOL,
                         f"block {tb.index} {name}")
        assert set(got[5]) == set(CELLAVG)
        for key in CELLAVG:
            assert_close(got[5][key], want[5][key], RTOL, ATOL,
                         f"block {tb.index} cellavg[{key}]")
    # CPU tensors take the plain version: no kernel launch
    assert vm.LAUNCHES.count == launches


def test_kernel_output_layout(pair):
    """split_outputs hands the kernel's 29 channels out as the plain
    version's tuple: packing the plain outputs and splitting them again
    gives them back."""
    from aither_tpu_torch.kernels import viscous_march as vm
    _, ts, inputs = pair
    b = ts.case.blocks[0]
    want = vm.viscous_residual(ts.phys, ts.cfg, b, *inputs[b.index])
    ca = want[5]
    packed = torch.cat([want[0], want[1][None], want[2][None],
                        want[3][None], want[4][None],
                        ca["vel"].reshape((9,) + want[1].shape),
                        ca["tke"], ca["omega"], ca["mut"][None],
                        ca["f1"][None], ca["f2"][None]])
    assert packed.shape[0] == sum(k for _, k in vm.out_channels(2))
    got = vm.split_outputs(packed)
    for i in range(5):
        assert torch.equal(got[i], want[i])
    for key in CELLAVG:
        assert torch.equal(got[5][key], ca[key])


def test_wrapper_rejects_other_devices_and_scopes(pair):
    from aither_tpu_torch.kernels import viscous_march as vm
    _, ts, inputs = pair
    b = ts.case.blocks[0]
    meta = [x.to("meta") for x in inputs[b.index]]
    with pytest.raises(ValueError, match="meta"):
        vm.viscous_residual(ts.phys, ts.cfg, b, *meta)
    for key, val in (("viscous_recon", "centralFourth"),
                     ("block_matrix", True)):
        with pytest.raises(ValueError, match="SST 2003"):
            vm.viscous_residual(ts.phys, dict(ts.cfg, **{key: val}), b,
                                *inputs[b.index])
    import dataclasses
    with pytest.raises(ValueError, match="SST 2003"):
        vm.viscous_residual(dataclasses.replace(
            ts.phys, thermo_model="thermallyPerfect"), ts.cfg, b,
            *inputs[b.index])


def test_cost_counts_every_face_once(pair):
    from aither_tpu_torch.kernels import viscous_march as vm
    _, ts, _ = pair
    b = ts.case.blocks[0]
    ni, nj, nk = b.ni, b.nj, b.nk
    faces = (ni + 1) * nj * nk + ni * (nj + 1) * nk + ni * nj * (nk + 1)
    nbytes, ops = vm.cost(b)
    assert ops == (vm.FACE_OPS_BY_MODEL[0] * faces
                   + vm.CELL_OPS_BY_MODEL[0] * ni * nj * nk)
    npad = int(np.prod(b.shape))
    assert nbytes == 8 * (9 * npad + 26 * faces + (4 + 29) * ni * nj * nk)
