"""PyTorch port, the fused viscous kernel's tile and segment schedule
(csrc/viscous_march.cu) on the CPU, with no kernel and no JAX.

The host plan (``viscous_march.viscous_tile``) covers every cell once, and
each face is computed by the CTAs (a tile of (j, k) columns by a segment of
i-planes) whose cells it bounds: once inside a CTA, by both CTAs on a
tile's j / k edge and on a segment's first i-plane.

An emulation of each CTA, written after the kernel's index arithmetic,
fills the ring of three window planes as the kernel does (plane i+2 into
the slot of plane i-1 once the faces of plane i are done), reads every
face's ten-point stencil of every window channel through the kernel's
window offsets and holds it bit for bit to the plain version's stencil in
the padded fields.  It takes each face's
record from the plain per-face math of the whole block
(``viscous.face_terms``), keeps the records in the kernel's buffers
(two i-face buffers swapped from step to step, the j- and k-faces of the
step), and combines each cell's six records with the kernel's expressions,
directions in the order i, j, k.  Written into the kernel's output layout
(``split_outputs``), that equals ``viscous.viscous_residual`` bit for bit in
all four branches.

Why the records come from the whole block: torch's CPU pow takes a vector
or a scalar path by an element's position in its tensor, and the two paths
differ by an ulp (2-5 elements of 200 on the machine this was written on),
so face math run on tile-sized batches cannot equal the whole-block version
bit for bit.  Showing that each face's inputs are the plain version's, bit
for bit, and evaluating them once says the same thing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aither_tpu_torch.cases import write_plate_case  # noqa: E402
from aither_tpu_torch.kernels import viscous_march as vm  # noqa: E402
from aither_tpu_torch.solver import step  # noqa: E402
from aither_tpu_torch.solver import viscous as vis  # noqa: E402

# turbulenceModel -> equationSet of the generated plate
PHYSICS = {"sst2003": "rans", "kOmegaWilcox2006": "rans",
           "wale": "largeEddySimulation", "none": "navierStokes"}
# (dims, plan): the default plans (one-plane segments of one tile at 9x7x5;
# 64-column tiles of 2 planes at case A's one-cell-thick 96x120x1), a plan
# ragged in j, k and i (segments of 4 over 9 planes), one-plane segments of
# ragged tiles, and case A's block in ragged 32-column tiles of 16 planes
PLANS = [((9, 7, 5), vm.viscous_tile((9, 7, 5))), ((9, 7, 5), (4, 3, 4)),
         ((9, 7, 5), (3, 2, 1)), ((96, 120, 1), vm.viscous_tile((96, 120, 1))),
         ((96, 120, 1), (32, 1, 16))]
SLOTS = 3


def ctas(dims, plan):
    """the kernel's CTAs in blockIdx order: (i0, planes, j0, ej, k0, ek)"""
    ni, nj, nk = dims
    tj, tk, seg = plan
    ntk = -(-nk // tk)
    ntiles = -(-nj // tj) * ntk
    out = []
    for bid in range(ntiles * -(-ni // seg)):
        tile = bid % ntiles
        i0 = bid // ntiles * seg
        j0, k0 = tile // ntk * tj, tile % ntk * tk
        out.append((i0, min(seg, ni - i0), j0, min(tj, nj - j0), k0,
                    min(tk, nk - k0)))
    return out


def test_default_plans():
    assert vm.viscous_tile((256, 64, 32)) == (3, 32, 22)
    assert vm.viscous_tile((96, 120, 1)) == (64, 1, 2)
    assert vm.viscous_tile((51, 44, 37)) == (3, 32, 13)
    for ni in (1, 9, 51, 256):
        for nj in (1, 2, 3, 7, 45, 64, 120, 500):
            for nk in range(1, 40):
                tj, tk, seg = vm.viscous_tile((ni, nj, nk))
                ncol = tj * tk
                # one face a thread, four threads a cell's combine
                assert 3 * ncol + tj + tk <= vm.THREADS
                assert 4 * ncol <= vm.THREADS and tk <= 32
                assert 1 <= seg <= vm.MAX_SEG
                for model in range(4):
                    assert vm.smem_bytes(model, tj, tk) <= vm.MAX_SMEM


def test_segments_fill_the_waves():
    """the segment length minimises waves x (seg + 1): at case B 22 tiles x
    12 segments, two full waves of 132 CTAs"""
    tj, tk, seg = vm.viscous_tile((256, 64, 32))
    ctas = (64 // tj + 1) * (-(-256 // seg))
    assert ctas == 2 * vm.SMS
    assert vm.smem_bytes(0, 3, 32) == 8 * (3 * 9 * 5 * 34 + 24 * 419
                                           + 21 * 323)


@pytest.mark.parametrize("dims,plan", PLANS + [((256, 64, 32), (3, 32, 22)),
                                               ((51, 44, 37), (3, 32, 13))])
def test_plan_covers_every_cell_once(dims, plan):
    count = np.zeros(dims, dtype=np.int64)
    for i0, npl, j0, ej, k0, ek in ctas(dims, plan):
        assert 0 < npl <= plan[2] and 0 < ej <= plan[0] and 0 < ek <= plan[1]
        count[i0:i0 + npl, j0:j0 + ej, k0:k0 + ek] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("dims,plan", PLANS + [((51, 44, 37), (3, 32, 13))])
def test_faces_computed_by_their_cells_ctas(dims, plan):
    """every face is computed by exactly the CTAs that own the cells on its
    two sides: the j / k faces of a tile's edge and the i-faces of a
    segment's first plane by two, every other face by one"""
    ni, nj, nk = dims
    owner = np.zeros(dims, dtype=np.int64)
    computed = {}
    for d in range(3):
        shape = list(dims)
        shape[d] += 1
        computed[d] = np.full(shape + [2], -1)

    def mark(d, sl, cta):
        seen = computed[d][sl]
        first = seen[..., 0] < 0
        assert (seen[..., 1][~first] < 0).all(), "a face computed 3 times"
        seen[..., 0][first] = cta
        seen[..., 1][~first] = cta
        computed[d][sl] = seen

    for n, (i0, npl, j0, ej, k0, ek) in enumerate(ctas(dims, plan)):
        owner[i0:i0 + npl, j0:j0 + ej, k0:k0 + ek] = n
        cols = (slice(j0, j0 + ej), slice(k0, k0 + ek))
        # the warm-up's lower faces and each step's upper i-faces
        mark(0, (slice(i0, i0 + npl + 1),) + cols, n)
        for p in range(npl):
            mark(1, (i0 + p, slice(j0, j0 + ej + 1), cols[1]), n)
            mark(2, (i0 + p, cols[0], slice(k0, k0 + ek + 1)), n)
    for d in range(3):
        pad = [(0, 0)] * 3
        pad[d] = (1, 1)
        side = np.pad(owner, pad, constant_values=-1)
        lo = np.take(side, range(0, dims[d] + 1), axis=d)
        hi = np.take(side, range(1, dims[d] + 2), axis=d)
        want = np.sort(np.stack([lo, hi], axis=-1), axis=-1)
        want[..., 0] = np.where(want[..., 0] == want[..., 1], -1,
                                want[..., 0])
        got = np.sort(computed[d], axis=-1)
        assert np.array_equal(got, want), f"direction {'ijk'[d]}"


# ---------------------------------------------------------------------------
# the kernel's schedule on the plain per-face math


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    """{(model, dims): (phys, cfg, [(block, prim, T, mu)])}: the seeded
    1%-perturbed plate after the full and the viscous ghost fill, built on
    first use"""
    from aither_tpu_torch.solver.driver import Solver
    have = {}

    def get(model, dims, face="thirdOrder"):
        if (model, dims, face) not in have:
            wd = str(tmp_path_factory.mktemp("plate"))
            s = Solver(write_plate_case(wd, *dims,
                                        equation_set=PHYSICS[model],
                                        turbulence_model=model,
                                        face_reconstruction=face),
                       device="cpu", workdir=wd)
            rng = np.random.default_rng(5)
            prims = {}
            for b in s.case.blocks:
                prim = b.prim0.numpy().copy()
                prim[b.interior] *= 1.0 + 0.01 * rng.random(
                    prim[b.interior].shape)
                prims[b.index] = torch.as_tensor(prim)
            prims = step.apply_all_bcs(s.phys, s.case, prims)
            blocks = []
            for b in s.case.blocks:
                prim = step.apply_boundary_ghosts(s.phys, b, prims[b.index],
                                                  viscous_pass=True)
                prim = step.apply_edge_ghosts(s.phys, b, prim,
                                              viscous_pass=True)
                t_all = s.phys.temperature(prim[s.phys.ie],
                                           prim[:s.phys.ns])
                blocks.append((b, prim, t_all, s.phys.viscosity(t_all)))
            have[(model, dims, face)] = (s.phys, s.cfg, blocks)
        return have[(model, dims, face)]
    return get


def records(phys, cfg, block, prim, t_all, mu_all):
    """{d: (channels, *F_d) numpy}: each face's record from the plain
    per-face math: fa, the velocity gradient (vg[3a+b] = d v_b / d x_a),
    with turbulence equations the k and omega gradients, mut, f1, f2"""
    out = {}
    for d in range(3):
        f = vis.face_terms(phys, cfg, block, prim, t_all, mu_all, "ijk"[d])
        g = f["grads"]
        parts = [f["fa"], g["vel"].reshape((9,) + f["mut"].shape)]
        if phys.nturb:
            parts += [g["tke"], g["omega"]]
        parts += [f["mut"][None], f["f1"][None], f["f2"][None]]
        out[d] = torch.cat(parts).numpy()
    return out


def emulate(phys, cfg, block, prim, t_all, mu_all, plan):
    """the kernel's launch on one block, CTA by CTA (see the module
    docstring): its (29 or 21, ni, nj, nk) output"""
    neq, nch, g = phys.neq, phys.neq + 2, block.g
    ni, nj, nk = block.ni, block.nj, block.nk
    P = vm._params(phys, cfg)
    scaling, gamma, visc_coeff, prt = P[0], P[3], P[10], P[17]
    sigma_k1, sigma_k2, sigma_star = P[12], P[13], P[18]
    model = cfg["turb_model"]
    fields = torch.cat([prim, t_all[None], mu_all[None]]).numpy()
    rec_of = records(phys, cfg, block, prim, t_all, mu_all)
    nrec = rec_of[0].shape[0]
    cell = vis.viscous_statics(block, vis.needs_face_length(cfg))["cell"]
    vol, fmag = cell[0].reshape(-1), cell[1:].reshape(3, -1)
    out = torch.full((sum(k for _, k in vm.out_channels(phys.nturb)), ni,
                      nj, nk), float("nan"), dtype=torch.float64)
    flat_out = out.view(out.shape[0], -1)
    written = np.zeros(ni * nj * nk, dtype=np.int64)
    sixth = 1.0 / 6.0
    unit = np.eye(3, dtype=np.int64)

    for i0, npl, j0, ej, k0, ek in ctas((ni, nj, nk), plan):
        wk = ek + 2
        wch = (ej + 2) * wk
        wslot = nch * wch
        ncol, njf, nkf = ej * ek, (ej + 1) * ek, ej * (ek + 1)
        nr = 2 * ncol + njf + nkf
        jrec, krec = 2 * ncol, 2 * ncol + njf
        win = np.full(SLOTS * wslot, np.nan)
        rec = np.full((nrec, nr), np.nan)

        def load(q, sl):
            win[sl * wslot:(sl + 1) * wslot] = fields[
                :, q + g, j0 - 1 + g:j0 + ej + 1 + g,
                k0 - 1 + g:k0 + ek + 1 + g].reshape(-1)

        def faces(d, lo, sd, u1, l1, u2, l2, cells, slots):
            """faces of direction d from the window: lower cells ``cells``
            (3, n) physical, window index ``lo``, stencil steps as the
            kernel's cv_gradient; their records into ``slots``"""
            t1, t2 = [x for x in range(3) if x != d]
            steps = [0, sd, sd + u1, u1, sd + l1, l1, sd + u2, u2, sd + l2,
                     l2]
            e, a, b = unit[d], unit[t1], unit[t2]
            points = [0 * e, e, e + a, a, e - a, -a, e + b, b, e - b, -b]
            for off, pt in zip(steps, points):
                c = cells + pt[:, None] + g
                want = fields[:, c[0], c[1], c[2]]
                got = win[np.arange(nch)[:, None] * wch + lo + off]
                assert np.array_equal(got, want), (d, off)
            face = cells.copy()
            face[d] += 1
            rec[:, slots] = rec_of[d][:, face[0], face[1], face[2]]

        def i_faces(q, sq, slots):
            c = np.arange(ncol)
            j, k = c // ek, c % ek
            cells = np.stack([np.full(ncol, q), j0 + j, k0 + k])
            faces(0, sq * wslot + (j + 1) * wk + (k + 1),
                  ((sq + 1) % 3 - sq) * wslot, wk, -wk, 1, -1, cells,
                  slots + c)

        # the ring: plane i0-1+q in slot q % 3
        load(i0 - 1, 0)
        load(i0, 1)
        load(i0 + 1, 2)
        ilo, ihi = 0, ncol
        i_faces(i0 - 1, 0, ilo)
        for p in range(npl):
            i = i0 + p
            s, s_up, s_dn = (p + 1) % 3, (p + 2) % 3, p % 3
            up, dn = (s_up - s) * wslot, (s_dn - s) * wslot
            i_faces(i, s, ihi)
            r = np.arange(njf)
            jj, k = r // ek, r % ek
            faces(1, s * wslot + jj * wk + (k + 1), wk, up, dn, 1, -1,
                  np.stack([np.full(njf, i), j0 + jj - 1, k0 + k]),
                  jrec + r)
            r = np.arange(nkf)
            j, kk = r // (ek + 1), r % (ek + 1)
            faces(2, s * wslot + (j + 1) * wk + kk, 1, up, dn, wk, -wk,
                  np.stack([np.full(nkf, i), j0 + j, k0 + kk - 1]),
                  krec + r)
            # plane i-1 is read no more: plane i+2 takes its slot
            if p + 1 < npl:
                load(i + 2, s_dn)

            # combine, with the kernel's expressions
            c = np.arange(ncol)
            j, k = c // ek, c % ek
            lo = [ilo + c, jrec + j * ek + k, krec + j * (ek + 1) + k]
            hi = [ihi + c, jrec + (j + 1) * ek + k,
                  krec + j * (ek + 1) + k + 1]
            t = torch.as_tensor((i * nj + j0 + j) * nk + k0 + k)
            written[t.numpy()] += 1
            wc = s * wslot + (j + 1) * wk + (k + 1)
            r_c = torch.as_tensor(win[wc])
            mu_c = torch.as_tensor(win[wc + (neq + 1) * wch])
            vol_c = vol[t]
            # gamma as a tensor, as the plain version has it: torch divides
            # by a Python number as a product with its reciprocal
            gam = torch.full_like(r_c, gamma)
            max_term = torch.maximum(4.0 / (3.0 * r_c), gam / r_c)
            prand = 4.0 * gam / (9.0 * gam - 5.0)
            R = torch.as_tensor(rec)
            acc = torch.zeros((out.shape[0], ncol), dtype=torch.float64)
            for d in range(3):
                rl, rh = R[:, lo[d]], R[:, hi[d]]
                acc[:neq] = acc[:neq] - (rh[:neq] - rl[:neq])
                # the cell averages: vel, tke, omega, mut, f1, f2
                acc[neq + 4:] = acc[neq + 4:] + sixth * (rl[neq:] + rh[neq:])
                lo_mut, lo_f1 = rl[nrec - 3], rl[nrec - 2]
                visc_term = scaling * (
                    mu_c / prand + (0.0 if model == "none"
                                    else lo_mut / prt))
                vsr = max_term * visc_term * fmag[d, t] * fmag[d, t] / vol_c
                acc[neq] = acc[neq] + visc_coeff * vsr
                acc[neq + 2] = acc[neq + 2] + 2.0 * vsr
                if phys.nturb:
                    if model == "kOmegaWilcox2006":
                        mut_nolim = (r_c * torch.as_tensor(win[wc + 5 * wch])
                                     / torch.as_tensor(win[wc + 6 * wch]))
                        tvsr = (scaling * (fmag[d, t] * fmag[d, t] / vol_c)
                                / r_c * (mu_c + sigma_star * mut_nolim))
                    else:
                        sk = lo_f1 * sigma_k1 + (1.0 - lo_f1) * sigma_k2
                        tvsr = (scaling * (fmag[d, t] * fmag[d, t] / vol_c)
                                / r_c * (mu_c + sk * lo_mut))
                    acc[neq + 1] = acc[neq + 1] + visc_coeff * tvsr
                    acc[neq + 3] = acc[neq + 3] + 2.0 * tvsr
            flat_out[:, t] = acc
            ilo, ihi = ihi, ilo
    assert (written == 1).all()
    return out


# every branch on every plan but case A's 16-plane segments (SST only); at
# case A's size the first block only, to keep the file short
SCHEDULES = ([(model, dims, plan) for dims, plan in PLANS[:4]
              for model in PHYSICS] + [("sst2003",) + PLANS[4]])


@pytest.mark.parametrize("model,dims,plan", SCHEDULES)
def test_schedule_is_the_plain_residual(plates, model, dims, plan):
    check_schedule(plates(model, dims), dims, plan)


@pytest.mark.parametrize("dims,plan", [PLANS[1]])
def test_schedule_is_the_plain_residual_at_three_ghost_layers(plates, dims,
                                                              plan):
    """SST with WENO-Z's three ghost layers, on the plan ragged in i, j
    and k"""
    phys, cfg, blocks = plates("sst2003", dims, "wenoZ")
    assert blocks[0][0].g == 3
    check_schedule((phys, cfg, blocks), dims, plan)


def check_schedule(plate, dims, plan):
    """the emulated schedule against the plain residual, bit for bit"""
    phys, cfg, blocks = plate
    for block, prim, t_all, mu_all in blocks[:1 if dims[2] == 1 else None]:
        got = vm.split_outputs(emulate(phys, cfg, block, prim, t_all,
                                       mu_all, plan))
        want = vis.viscous_residual(phys, cfg, block, prim, t_all, mu_all)
        for n in range(5):
            assert torch.equal(got[n], want[n]), (block.index, n)
        assert set(got[5]) == set(want[5])
        for key, w in want[5].items():
            assert torch.equal(got[5][key], w), (block.index, key)
