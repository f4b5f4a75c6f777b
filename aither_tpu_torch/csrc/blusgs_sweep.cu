// Block-matrix LU-SGS (BLU-SGS) hyperplane sweep for NVIDIA Hopper
// (sm_90a), float64.
//
// Replaces the TPU kernel aither_tpu/solver/pallas_sweep.py::sweep
// (pallas_call at pallas_sweep.py:342) with block_matrix set, variant (c):
// Rusanov off-diagonal, without and with the lagged opposite-side term
// `extra` (matrixSweeps > 1, variant (c)+(b)), for one species or a
// mixture of any count NS (flow blocks of N = NS + 4; a build holds NS =
// 1..BASE_NS, or with -DSWEEP_NS=N one count N > BASE_NS, the library
// <name>_ns<N>), in the forms the models need, each a compile-time
// instantiation of one sweep_tiles<NS, NEQ, VISCOUS, WILCOX, FORWARD>:
//   N equations inviscid (Euler): the Rusanov rows only; mu, mut, f1,
//     vgrad and the centre distance are not read;
//   N equations viscous (laminar, LES): Rusanov -+ the thin-shear-layer
//     rows with mu + mut and no turbulent conductivity (as
//     block_jac._tsl_rows without turbulence equations); N*N inverse
//     channels, inv_t null;
//   N + 2 equations SST 2003 / SST-DES: plus the 2x2 turbulence block with
//     the blended sigma_k, sigma_w and the mut field;
//   N + 2 equations Wilcox 2006: that block with sigma*, sigma constant
//     and the unlimited rho k / omega of the neighbour state.
// A mixture (add_block_offdiagonal_mix) takes its per-species constants
// (struct Mixture) and evaluates per neighbour state its gamma, energy, cp
// and conductivity (Sutherland per species, mixed as 0.5 (sum x_s k_s +
// 1 / sum x_s / k_s) over the mole fractions x_s); its Rusanov rows carry
// the species block vn (delta_ij - mf_i) and mf_i n, and with Schmidt
// diffusion (diffusion != 0) its TSL rows the species-diffusion block
// dcoeff (delta_ij - mf_i) / (mu_tot rho), dcoeff = mu/Sc + mut/Sct, and
// in the energy row the diffusion's enthalpy flux h_s + V^2/2
// (block_jac.py:204-227 of the JAX package).
// ROE selects the off-diagonal of `inviscidFluxJacobian: approximateRoe`:
// the Roe flux change of roe_offdiag.cuh, the same vector the scalar sweep
// takes (no Jacobian rows and no vgrad), in place of the Rusanov and TSL
// block rows; the block inverse of finish_rows is unchanged.  It replaces
// the JAX package's scan path of aither_tpu/solver/implicit.py:113
// roe_offdiagonal with block_matrix set (no Pallas form there).  A build
// holds the Rusanov forms (library blusgs_sweep) or, with -DSWEEP_ROE=1,
// the Roe forms (library blusgs_sweep_roe).  The Roe forms split the
// product as the scalar sweep's do: a pre-pass launch stores the old Roe
// flux and the radii once per face (roe_offdiag.cuh store_roe_old_terms,
// the scalar sweep's face values), the wavefront's lanes evaluate only the
// new flux of q + du against them, and the wavefront runs on persistent
// CTAs.
// A build with -DSWEEP_TP=1 (library blusgs_sweep_tp) holds the thermally
// perfect forms of the Rusanov and TSL rows, and with -DSWEEP_ROE=1 as
// well (blusgs_sweep_roe_tp) those of the Roe flux change: every species
// count takes add_block_offdiagonal_mix (one species with mass fraction
// 1), with each species' energy, enthalpy, cv and cp functions of T
// (thermo_tp.cuh): the neighbour's gamma, energy and cp (the turbulent
// conductivity) from its T, its conductivity, and the diffusion's species
// enthalpies.  It replaces the JAX package's scan sweep of such a deck
// (pallas_sweep.use_pallas turns its kernel off there).  Phys's gamma is
// not read.  The thermally perfect forms split the product too: the
// Rusanov ones' pre-pass evaluates those old-state terms once per padded
// cell (store_cell_terms; each cell is the neighbour of three faces), and
// their lanes read them; the Roe ones' pre-pass adds, to the Roe forms'
// face terms, each cell's old energy and each ghost neighbour's q + du,
// and a stage of the wavefront inverts each updated state once on
// thermo::SPEC_LANES lanes, whose q + du the lanes read (tp_state.cuh,
// shared with the scalar sweep's thermally perfect forms).
// The viscous calorically perfect Rusanov forms' pre-pass stores each
// padded cell's conductivity (a pow, and for a mixture a division per
// species and their mole fractions), which their lanes read (CELL_K); an
// inviscid calorically perfect Rusanov form has no pre-pass.  The Rusanov
// and thermally perfect forms' finish loads its operands before its first
// store where registers allow (finish_rows, LOADS_FIRST), and every form
// runs on persistent CTAs.
// The scalar sweep of variants (a)/(b) is csrc/lusgs_sweep.cu; this file
// keeps its structure.
//
// What it computes (reference: linearSolver.cpp:341-428): for every
// hyperplane p = i+j+k in order (forward: increasing p, backward:
// decreasing), every physical cell c of the plane becomes
//   forward:  du[c] = D_c^-1 (b[c] + sum_d L_d [- extra[c]])
//   backward: du[c] = du[c] - D_c^-1 sum_d U_d
//             or, with extra, D_c^-1 (b[c] + extra[c] - sum_d U_d)
// where L_d / U_d is the block off-diagonal product of the lower / upper
// neighbour across direction d (aither_tpu implicit.
// offdiagonal_block_channels): the Rusanov block Jacobian
// 0.5|A|(dF/dU +- specRad I) times du (block_jac.rusanov_offdiag_matvec)
// minus / plus the thin-shear-layer viscous Jacobian times du
// (block_jac.tsl_offdiag_matvec: rows . (dPrim/dCons . du)), with the
// 2x2 turbulence block 0.5|A|(vn +- |vn|) + the TSL turbulence diagonal.
// D_c^-1 is the cell's inverted N x N flow and 2x2 turbulence block.
// extra is computed before the sweep by implicit.offdiag_sum.  du is
// updated IN PLACE: a plane reads only the plane before it.
//
// Schedule: a pre-pass launch (the forms of split()) and one wavefront
// launch per block and sweep, the tile wavefront of sweep_wavefront.cuh on
// persistent CTAs, as in the scalar sweep.  Each cell's arithmetic is
// the plane kernel's: each direction's product (direction_product) gives
// two addends per row, the Rusanov or turbulence one and the
// thin-shear-layer one, summed for the three directions in the order i, j,
// k from 0.0 as the plane kernel's running sum took them; then the
// right-hand side and D^-1 (finish_rows, a third of the rows per lane).
//
// Layout: prim, du (NEQ, NI, NJ, NK), mu, mut, f1 (NI, NJ, NK) and the
// neighbours' cell-average velocity gradient vgrad (3, 3, NI, NJ, NK),
// vgrad[a][b] = d v_b / d x_a, padded; b, extra (NEQ, ni, nj, nk) and the
// inverse blocks inv_f (25, ni, nj, nk) row-major, inv_t (4, ni, nj, nk)
// physical, channel first so that a warp reads each channel in one pass
// (inv_f holds N*N channels).  Per physical cell and direction the face
// normal, area and centre distance (stat) and whether the neighbour
// contributes (mask), in physical cell order.  A masked face is skipped
// by a branch, never multiplied by zero: a ghost state there may be
// garbage.
//
// Each Jacobian is built row by row into the running sum (as
// block_jac.rows_matvec): no N x N matrix is held in registers.
//
// What bounds it on the card: the bytes a forward+backward pair at 1M cells
// must move take under 0.5 ms at 3.35 TB/s, its ~2 GFLOP of FP64 ~0.06 ms
// at 34 TFLOP/s (kernels/lusgs_sweep.py sweep_cost; PERF.md).  Like the
// scalar sweep it is held instead by the chain of ni+nj+nk-2 dependent
// planes per block and sweep: the time of one step is a barrier, the
// flags between tiles and one cell's serial FP64 work, split over three
// lanes.  A Roe step does q + du and the new Roe flux per direction in
// place of the block rows (the old flux stored by the pre-pass); a
// thermally perfect Roe step the new Roe flux of the stored q + du, then
// the stage's inversion of the plane's updated states.  Past
// about 8 species the per-thread rows (NS + 6 doubles each) and the N x N
// inverse product (N up to 20 at 16 species) spill to local memory; the
// species constants pass by value, under the classic 4 KB of kernel
// parameters at 16 species with a thermally perfect gas's table of up to
// 256 vibrational modes (thermo_tp.cuh).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "roe_offdiag.cuh"
#include "sweep_wavefront.cuh"
#include "tp_state.cuh"

// 1: this translation unit holds the approximateRoe forms (the library
// blusgs_sweep_roe, utils/build.py VARIANTS), 0: the Rusanov forms
#ifndef SWEEP_ROE
#define SWEEP_ROE 0
#endif
// 1: the forms carry the step clocks' marks (sweep_wavefront.cuh,
// namespace probe): only the build of the probe, library <name>_probe, for
// utils/sweep_probe.py
#ifndef SWEEP_PROBE
#define SWEEP_PROBE 0
#endif

namespace {

constexpr int NSTAT = 5;       // nx, ny, nz, mag, dist per direction
// species counts of a build without SWEEP_NS: 1..BASE_NS
constexpr int BASE_NS = 5;

struct Phys {
  double R, cv, cp, hf, gamma, prt, scaling;
  double t_ref, cond_c1, cond_s, k_nondim;
  // SST blends; Wilcox: sigma* in sigma_k1 and sigma in sigma_w1
  double sigma_k1, sigma_k2, sigma_w1, sigma_w2;
};

// the Roe forms' constants: those of Phys, the laminar Prandtl number
// and the turbulence floors of q + du (the Rusanov forms take Phys as
// it is, so that their code is unchanged)
struct PhysRoe : Phys {
  double prandtl, tmin_k, tmin_w;
};

// the forms of this translation unit: the approximateRoe off-diagonal,
// the thermally perfect gas.  The thermally perfect Roe forms invert each
// updated state once, in a stage of the wavefront.  Every form runs on
// persistent CTAs
constexpr bool ROE = SWEEP_ROE != 0;
constexpr bool TP = SWEEP_TP != 0;
constexpr bool STAGED = ROE && TP;

// whether a form splits the product with a pre-pass: the Roe and the
// thermally perfect forms, and the viscous calorically perfect Rusanov
// ones (their neighbour state's conductivity once per cell, CELL_K); an
// inviscid calorically perfect Rusanov form has no old-state term worth
// storing
template <bool VISCOUS>
__host__ __device__ constexpr bool split() {
  return ROE || TP || VISCOUS;
}

using KernelPhys = std::conditional_t<ROE, PhysRoe, Phys>;

// per-species constants of a mixture (read when NS > 1): gas constant,
// cv, cp, heat of formation, Sutherland conductivity coefficients and the
// dimensional molar mass; the Schmidt numbers and whether species diffuse
template <int NS>
struct Mixture {
  double R[NS], cv[NS], cp[NS], hf[NS], cond_c1[NS], cond_s[NS], mm[NS];
  double schmidt, turb_schmidt;
  int diffusion;
#if SWEEP_TP
  thermo::Vib<NS> vib;   // the thermally perfect forms' modes
#endif
};

struct Fields {
  const double* __restrict__ prim;
  double* du;        // written by other SMs during the launch: __ldcg only
  const double* __restrict__ mu;
  const double* __restrict__ mut;
  const double* __restrict__ f1;
  const double* __restrict__ vgrad;
  const double* __restrict__ b;
  const double* __restrict__ extra;  // nullptr: no lagged term
  const double* __restrict__ inv_f;
  const double* __restrict__ inv_t;
  const double* __restrict__ stat;   // physical cell order
  const unsigned char* __restrict__ mask;
  int64_t nc;        // NI*NJ*NK: channel stride of the padded fields
  int64_t ncp;       // ni*nj*nk: channel stride of b, extra, inv_f, inv_t
  int64_t base;      // padded flat index of physical cell (0, 0, 0)
  int64_t stride[3]; // flat step of one cell in i, j, k
  // the pre-pass forms' work space (launch_tiles, split()), written by
  // the pre-pass and read by the wavefront (__ldg); null for the other
  // forms.  Roe: per face of the sweep side its flux::roe_face_values (3
  // ncp faces); Rusanov: per padded cell its old-state terms (CELL_*, nc
  // cells)
  double* pre;
#if SWEEP_TP
  // the thermally perfect Roe forms' updated states (tp_state.cuh
  // tp_state_space): per physical cell its old energy (written by the
  // pre-pass), per padded cell q + du (the pre-pass writes the ghosts',
  // the stage the physical cells', read through L2, __ldcg)
  double* eold;      // (ncp)
  double* qu;        // (NEQ, nc)
#endif
};

// The old-state terms per padded cell that a Rusanov form's pre-pass
// stores (Fields::pre, channel stride nc) and its lanes read in place of
// evaluating them per face: thermally perfect, the mixture's gamma = cp(T)
// / cv(T) and energy sum_s mf_s e_s(T); viscous, its conductivity and its
// cp(T) (read with turbulence equations) and each species' enthalpy h_s(T)
// (read with Schmidt diffusion), each written only where it is read;
// calorically perfect (viscous), the conductivity alone, in channel 0
// (kernels/lusgs_sweep.py cell_values)
constexpr int CELL_GAMMA = 0, CELL_ENERGY = 1, CELL_K = TP ? 2 : 0,
              CELL_CP = 3, CELL_H = 4;

// block off-diagonal product of the neighbour nb across one face, added to
// acc (aither_tpu implicit.offdiagonal_block_channels, one species).
// FORWARD: the lower neighbour (positive, TSL "left").
template <int NEQ, bool VISCOUS, bool WILCOX, bool FORWARD>
__device__ __forceinline__ void add_block_offdiagonal(const Phys& ph,
                                                      const Fields& fl,
                                                      int64_t nb,
                                                      const double* st,
                                                      const double dq[NEQ],
                                                      double acc[NEQ],
                                                      double acc_t[NEQ]) {
  const int64_t nc = fl.nc;
  // the pre-pass's conductivity of the neighbour state (CELL_K)
  double k = 0.0;
  if constexpr (VISCOUS) k = __ldg(fl.pre + CELL_K * nc + nb);
  const double rho = fl.prim[nb];
  const double u = fl.prim[nc + nb];
  const double v = fl.prim[2 * nc + nb];
  const double w = fl.prim[3 * nc + nb];
  const double p = fl.prim[4 * nc + nb];
  const double n0 = st[0], n1 = st[1], n2 = st[2], mag = st[3];

  const double t = p / (ph.R * rho);
  const double vn = u * n0 + v * n1 + w * n2;
  const double vmag2 = u * u + v * v + w * w;
  const double gm1 = ph.gamma - 1.0;
  const double sgn = FORWARD ? 1.0 : -1.0;
  if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS);

  // Rusanov block: 0.5|A| dF/dU rows (mass fraction 1) +- spectral radius
  {
    const double phi = 0.5 * gm1 * vmag2;
    const double a1 = ph.gamma * (ph.hf + ph.cv * t + 0.5 * vmag2) - phi;
    const double a3 = ph.gamma - 2.0;
    const double hm = 0.5 * mag;
    const double spec = hm * (fabs(vn) + sqrt(ph.gamma * p / rho));
    acc[0] += hm * (n0 * dq[1] + n1 * dq[2] + n2 * dq[3]) + sgn * spec * dq[0];
    acc[1] += hm * ((phi * n0 - u * vn) * dq[0] + (vn - a3 * n0 * u) * dq[1] +
                    (u * n1 - gm1 * v * n0) * dq[2] +
                    (u * n2 - gm1 * w * n0) * dq[3] + gm1 * n0 * dq[4]) +
              sgn * spec * dq[1];
    acc[2] += hm * ((phi * n1 - v * vn) * dq[0] +
                    (v * n0 - gm1 * u * n1) * dq[1] +
                    (vn - a3 * n1 * v) * dq[2] +
                    (v * n2 - gm1 * w * n1) * dq[3] + gm1 * n1 * dq[4]) +
              sgn * spec * dq[2];
    acc[3] += hm * ((phi * n2 - w * vn) * dq[0] +
                    (w * n0 - gm1 * u * n2) * dq[1] +
                    (w * n1 - gm1 * v * n2) * dq[2] +
                    (vn - a3 * n2 * w) * dq[3] + gm1 * n2 * dq[4]) +
              sgn * spec * dq[3];
    acc[4] += hm * (vn * (phi - a1) * dq[0] + (a1 * n0 - gm1 * u * vn) * dq[1] +
                    (a1 * n1 - gm1 * v * vn) * dq[2] +
                    (a1 * n2 - gm1 * w * vn) * dq[3] +
                    ph.gamma * vn * dq[4]) +
              sgn * spec * dq[4];
  }
  if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS + 1);

  // thin-shear-layer block, subtracted forward and added backward
  // (s = -1 / +1); its turbulence diagonal carries fac = -1 / +1, so that
  // part enters with s * fac = +1 in both sweeps
  double mu = 0.0, mut = 0.0, dist = 0.0;
  if constexpr (VISCOUS) {
    mu = fl.mu[nb];
    mut = fl.mut[nb];
    dist = st[4];
    const double mu_s = ph.scaling * mu;
    const double mut_s = ph.scaling * mut;
    const double mu_tot = mu_s + mut_s;
    const double s = FORWARD ? -1.0 : 1.0;
    const double fac = FORWARD ? -1.0 : 1.0;
    // the turbulent conductivity only with turbulence equations
    // (block_jac._tsl_rows)
    const double kt = NEQ == 7 ? mut_s * ph.cp / ph.prt : 0.0;
    // tau = lambda tr(G) n + mu_tot (G + G^T) n
    const double* g = fl.vgrad + nb;
    const double g00 = g[0], g01 = g[nc], g02 = g[2 * nc];
    const double g10 = g[3 * nc], g11 = g[4 * nc], g12 = g[5 * nc];
    const double g20 = g[6 * nc], g21 = g[7 * nc], g22 = g[8 * nc];
    const double lt = -2.0 / 3.0 * mu_tot * (g00 + g11 + g22);
    const double tau0 = lt * n0 + mu_tot * ((g00 + g00) * n0 +
                                            (g01 + g10) * n1 +
                                            (g02 + g20) * n2);
    const double tau1 = lt * n1 + mu_tot * ((g10 + g01) * n0 +
                                            (g11 + g11) * n1 +
                                            (g12 + g21) * n2);
    const double tau2 = lt * n2 + mu_tot * ((g20 + g02) * n0 +
                                            (g21 + g12) * n1 +
                                            (g22 + g22) * n2);
    // dPrim/dCons . du
    const double ir = 1.0 / rho;
    const double dp1 = -ir * u * dq[0] + ir * dq[1];
    const double dp2 = -ir * v * dq[0] + ir * dq[2];
    const double dp3 = -ir * w * dq[0] + ir * dq[3];
    const double dp4 = 0.5 * gm1 * vmag2 * dq[0] - gm1 * u * dq[1] -
                       gm1 * v * dq[2] - gm1 * w * dq[3] + gm1 * dq[4];
    // TSL rows (primitive) . dp, times scale = |A| mu_tot / d
    const double scale = s * (mag * mu_tot / dist);
    const double third = 1.0 / 3.0;
    const double ndp = third * (n0 * dp1 + n1 * dp2 + n2 * dp3);
    acc_t[1] += scale * (dp1 + n0 * ndp);
    acc_t[2] += scale * (dp2 + n1 * ndp);
    acc_t[3] += scale * (dp3 + n2 * ndp);
    const double kk = (k + kt) / (mu_tot * rho);
    const double hd = fac * 0.5 * dist / mu_tot;
    acc_t[4] += scale * (-kk * t * dq[0] +
                       (hd * tau0 + third * n0 * vn + u) * dp1 +
                       (hd * tau1 + third * n1 * vn + v) * dp2 +
                       (hd * tau2 + third * n2 * vn + w) * dp3 + kk * dp4);
  }

  // turbulence: Rusanov 0.5|A|(vn +- |vn|) plus the TSL diagonal
  if constexpr (NEQ == 7) {
    const double tdiag = 0.5 * vn * mag + sgn * (0.5 * fabs(vn) * mag);
    if constexpr (VISCOUS) {
      const double length = ph.scaling * mag / dist / rho;
      double sk, sw, mutx;
      if constexpr (WILCOX) {
        sk = ph.sigma_k1;
        sw = ph.sigma_w1;
        mutx = rho * fl.prim[5 * nc + nb] / fl.prim[6 * nc + nb];
      } else {
        const double f1 = fl.f1[nb];
        sk = f1 * ph.sigma_k1 + (1.0 - f1) * ph.sigma_k2;
        sw = f1 * ph.sigma_w1 + (1.0 - f1) * ph.sigma_w2;
        mutx = mut;
      }
      acc[5] += (tdiag + length * (mu + sk * mutx)) * dq[5];
      acc[6] += (tdiag + length * (mu + sw * mutx)) * dq[6];
    } else {
      acc[5] += tdiag * dq[5];
      acc[6] += tdiag * dq[6];
    }
  }
  if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS + 2);
}

// the one species' conductivity (Sutherland) at T = t, times the
// nondimensional scaling
__device__ __forceinline__ double conductivity(const Phys& ph, double t) {
  const double td = t * ph.t_ref;
  return ph.scaling *
         (ph.cond_c1 * pow(td, 1.5) / (td + ph.cond_s) / ph.k_nondim);
}

// the mixture's conductivity (Sutherland per species, mixed over the mole
// fractions x_s as 0.5 (sum x_s k_s + 1 / sum x_s / k_s)) at T = t, times
// the nondimensional scaling, of mass fractions mf
template <int NS>
__device__ __forceinline__ double mixture_conductivity(const Phys& ph,
                                                       const Mixture<NS>& sp,
                                                       const double mf[NS],
                                                       double t) {
  const double td = t * ph.t_ref;
  const double td15 = pow(td, 1.5);
  double xs = 0.0;
#pragma unroll
  for (int q = 0; q < NS; ++q) xs += mf[q] / sp.mm[q];
  double weighted = 0.0, harmonic = 0.0;
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    const double kq = sp.cond_c1[q] * td15 / (td + sp.cond_s[q]) /
                      ph.k_nondim;
    const double x = (mf[q] / sp.mm[q]) / xs;
    weighted += x * kq;
    harmonic += x / kq;
  }
  return ph.scaling * (0.5 * (weighted + 1.0 / harmonic));
}

// block off-diagonal product of the neighbour nb across one face, added to
// acc, for a mixture of NS species (aither_tpu
// implicit.offdiagonal_block_channels).  The rows of the one-species form
// with the mixture's gamma and energy, the species column sums S = sum_j
// du_j in place of du_0, and the species rows.
template <int NS, int NEQ, bool VISCOUS, bool WILCOX, bool FORWARD>
__device__ __forceinline__ void add_block_offdiagonal_mix(
    const Phys& ph, const Mixture<NS>& sp, const Fields& fl, int64_t nb,
    const double* st, const double dq[NEQ], double acc[NEQ],
    double acc_t[NEQ]) {
  constexpr int N = NS + 4;
  const int64_t nc = fl.nc;
  double mf[NS];
  double rho = 0.0, rr = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    mf[s] = fl.prim[s * nc + nb];
    rho += mf[s];
    rr += sp.R[s] * mf[s];
  }
  const double u = fl.prim[NS * nc + nb];
  const double v = fl.prim[(NS + 1) * nc + nb];
  const double w = fl.prim[(NS + 2) * nc + nb];
  const double p = fl.prim[(NS + 3) * nc + nb];
  const double t = p / rr;
  double cpm = 0.0, cvm = 0.0, em = 0.0, gamma, k = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) mf[s] = mf[s] / rho;
  // the pre-pass's terms of the neighbour state (CELL_*)
  const double* tv = fl.pre + nb;
  if constexpr (VISCOUS) k = __ldg(tv + CELL_K * nc);
  if constexpr (TP) {
    gamma = __ldg(tv + CELL_GAMMA * nc);
    em = __ldg(tv + CELL_ENERGY * nc);
    if constexpr (NEQ == N + 2) cpm = __ldg(tv + CELL_CP * nc);
  } else {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      cpm += sp.cp[s] * mf[s];
      cvm += sp.cv[s] * mf[s];
      em += (sp.hf[s] + sp.cv[s] * t) * mf[s];
    }
    gamma = cpm / cvm;
  }
  double S = 0.0;  // the species columns' common factor
#pragma unroll
  for (int s = 0; s < NS; ++s) S += dq[s];
  const double n0 = st[0], n1 = st[1], n2 = st[2], mag = st[3];

  const double vn = u * n0 + v * n1 + w * n2;
  const double vmag2 = u * u + v * v + w * w;
  const double gm1 = gamma - 1.0;
  const double sgn = FORWARD ? 1.0 : -1.0;
  const double dm0 = dq[NS], dm1 = dq[NS + 1], dm2 = dq[NS + 2];
  const double de = dq[NS + 3];
  if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS);

  // Rusanov block: 0.5|A| dF/dU rows +- spectral radius
  {
    const double phi = 0.5 * gm1 * vmag2;
    const double a1 = gamma * (em + 0.5 * vmag2) - phi;
    const double a3 = gamma - 2.0;
    const double hm = 0.5 * mag;
    const double spec = hm * (fabs(vn) + sqrt(gamma * p / rho));
    const double ndm = n0 * dm0 + n1 * dm1 + n2 * dm2;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      acc[s] += hm * (vn * dq[s] - mf[s] * vn * S + mf[s] * ndm) +
                sgn * spec * dq[s];
    acc[NS] += hm * ((phi * n0 - u * vn) * S + (vn - a3 * n0 * u) * dm0 +
                     (u * n1 - gm1 * v * n0) * dm1 +
                     (u * n2 - gm1 * w * n0) * dm2 + gm1 * n0 * de) +
               sgn * spec * dm0;
    acc[NS + 1] += hm * ((phi * n1 - v * vn) * S +
                         (v * n0 - gm1 * u * n1) * dm0 +
                         (vn - a3 * n1 * v) * dm1 +
                         (v * n2 - gm1 * w * n1) * dm2 + gm1 * n1 * de) +
                   sgn * spec * dm1;
    acc[NS + 2] += hm * ((phi * n2 - w * vn) * S +
                         (w * n0 - gm1 * u * n2) * dm0 +
                         (w * n1 - gm1 * v * n2) * dm1 +
                         (vn - a3 * n2 * w) * dm2 + gm1 * n2 * de) +
                   sgn * spec * dm2;
    acc[NS + 3] += hm * (vn * (phi - a1) * S + (a1 * n0 - gm1 * u * vn) * dm0 +
                         (a1 * n1 - gm1 * v * vn) * dm1 +
                         (a1 * n2 - gm1 * w * vn) * dm2 + gamma * vn * de) +
                   sgn * spec * de;
  }
  if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS + 1);

  // thin-shear-layer block, subtracted forward and added backward
  double mu = 0.0, mut = 0.0, dist = 0.0;
  if constexpr (VISCOUS) {
    mu = fl.mu[nb];
    mut = fl.mut[nb];
    dist = st[4];
    const double mu_s = ph.scaling * mu;
    const double mut_s = ph.scaling * mut;
    const double mu_tot = mu_s + mut_s;
    const double s = FORWARD ? -1.0 : 1.0;
    const double fac = FORWARD ? -1.0 : 1.0;
    // the turbulent conductivity only with turbulence equations
    const double kt = NEQ == N + 2 ? mut_s * cpm / ph.prt : 0.0;
    const double* g = fl.vgrad + nb;
    const double g00 = g[0], g01 = g[nc], g02 = g[2 * nc];
    const double g10 = g[3 * nc], g11 = g[4 * nc], g12 = g[5 * nc];
    const double g20 = g[6 * nc], g21 = g[7 * nc], g22 = g[8 * nc];
    const double lt = -2.0 / 3.0 * mu_tot * (g00 + g11 + g22);
    const double tau0 = lt * n0 + mu_tot * ((g00 + g00) * n0 +
                                            (g01 + g10) * n1 +
                                            (g02 + g20) * n2);
    const double tau1 = lt * n1 + mu_tot * ((g10 + g01) * n0 +
                                            (g11 + g11) * n1 +
                                            (g12 + g21) * n2);
    const double tau2 = lt * n2 + mu_tot * ((g20 + g02) * n0 +
                                            (g21 + g12) * n1 +
                                            (g22 + g22) * n2);
    // dPrim/dCons . du (the species rows are the identity)
    const double ir = 1.0 / rho;
    const double dp1 = -ir * u * S + ir * dm0;
    const double dp2 = -ir * v * S + ir * dm1;
    const double dp3 = -ir * w * S + ir * dm2;
    const double dp4 = 0.5 * gm1 * vmag2 * S - gm1 * u * dm0 -
                       gm1 * v * dm1 - gm1 * w * dm2 + gm1 * de;
    const double scale = s * (mag * mu_tot / dist);
    const double third = 1.0 / 3.0;
    const double ndp = third * (n0 * dp1 + n1 * dp2 + n2 * dp3);
    acc_t[NS] += scale * (dp1 + n0 * ndp);
    acc_t[NS + 1] += scale * (dp2 + n1 * ndp);
    acc_t[NS + 2] += scale * (dp3 + n2 * ndp);
    const double kk = (k + kt) / (mu_tot * rho);
    const double hd = fac * 0.5 * dist / mu_tot;
    double e_species = -kk * t * S;
    if (sp.diffusion) {
      const double dc =
          (mu_s / sp.schmidt + mut_s / sp.turb_schmidt) / (mu_tot * rho);
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        acc_t[q] += scale * (dc * (dq[q] - mf[q] * S));
        double hq;
        if constexpr (TP)
          hq = __ldg(fl.pre + (CELL_H + q) * nc + nb);
        else
          hq = sp.hf[q] + sp.cp[q] * t;
        e_species += dc * (1.0 - mf[q]) * (hq + 0.5 * vmag2) * dq[q];
      }
    }
    acc_t[NS + 3] += scale * (e_species +
                            (hd * tau0 + third * n0 * vn + u) * dp1 +
                            (hd * tau1 + third * n1 * vn + v) * dp2 +
                            (hd * tau2 + third * n2 * vn + w) * dp3 +
                            kk * dp4);
  }

  // turbulence: Rusanov 0.5|A|(vn +- |vn|) plus the TSL diagonal
  if constexpr (NEQ == N + 2) {
    const double tdiag = 0.5 * vn * mag + sgn * (0.5 * fabs(vn) * mag);
    if constexpr (VISCOUS) {
      const double length = ph.scaling * mag / dist / rho;
      double sk, sw, mutx;
      if constexpr (WILCOX) {
        sk = ph.sigma_k1;
        sw = ph.sigma_w1;
        mutx = rho * fl.prim[N * nc + nb] / fl.prim[(N + 1) * nc + nb];
      } else {
        const double f1 = fl.f1[nb];
        sk = f1 * ph.sigma_k1 + (1.0 - f1) * ph.sigma_k2;
        sw = f1 * ph.sigma_w1 + (1.0 - f1) * ph.sigma_w2;
        mutx = mut;
      }
      acc[N] += (tdiag + length * (mu + sk * mutx)) * dq[N];
      acc[N + 1] += (tdiag + length * (mu + sw * mutx)) * dq[N + 1];
    } else {
      acc[N] += tdiag * dq[N];
      acc[N + 1] += tdiag * dq[N + 1];
    }
  }
  if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS + 2);
}

using wavefront::stride_of;

// Direction d's block off-diagonal product of one cell: its Rusanov and
// turbulence rows added to x, its thin-shear-layer (and species diffusion)
// rows to x_t, the two addends of each row in the plane kernel's running
// sum.  c and pc are the cell's padded and physical flat indices.  du is
// read through L2 (__ldcg): other SMs write it during the launch.  A
// masked face adds nothing.  The Rusanov forms.
template <int NS, int NEQ, bool VISCOUS, bool WILCOX, bool FORWARD>
__device__ __forceinline__ void direction_product(
    const Fields& fl, const Phys& ph, const Mixture<NS>& sp, int64_t c,
    int64_t pc, int d, double x[NEQ], double x_t[NEQ]) {
  if (!fl.mask[3 * pc + d]) return;
  const int64_t nb = FORWARD ? c - stride_of(fl, d) : c + stride_of(fl, d);
  const double* st = fl.stat + (3 * pc + d) * NSTAT;
  double dq[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) dq[e] = __ldcg(fl.du + e * fl.nc + nb);
  if constexpr (NS == 1 && !TP)
    add_block_offdiagonal<NEQ, VISCOUS, WILCOX, FORWARD>(ph, fl, nb, st, dq,
                                                         x, x_t);
  else
    add_block_offdiagonal_mix<NS, NEQ, VISCOUS, WILCOX, FORWARD>(
        ph, sp, fl, nb, st, dq, x, x_t);
}

// ---------------------------------------------------------------------------
// The pre-pass forms (split()): nothing of the old state changes during a
// sweep, so a pre-pass launch, one thread per face 3 pc + d of the sweep
// side (fully parallel), evaluates once what the lanes read of it.  Roe:
// per unmasked face the old Roe flux F_roe(q_nb | q_cell) and the radii
// (flux::store_roe_old_terms, the scalar sweep's face function); thermally
// perfect, per physical cell its old energy and per ghost neighbour of an
// unmasked face its q + du (tp_state.cuh, the scalar sweep's).  Rusanov:
// per physical cell (the thread of its face d = 0) and per ghost neighbour
// of an unmasked face the state's terms (store_cell_terms).

// the old-state terms of padded cell c of a Rusanov form (CELL_*), with
// the arithmetic of the state of add_block_offdiagonal (one calorically
// perfect species) or add_block_offdiagonal_mix
template <int NS, int NEQ, bool VISCOUS>
__device__ __forceinline__ void store_cell_terms(const Fields& fl,
                                                 const Phys& ph,
                                                 const Mixture<NS>& sp,
                                                 int64_t c) {
  const int64_t nc = fl.nc;
  double* out = fl.pre + c;
  if constexpr (NS == 1 && !TP) {
    // the calorically perfect one species' conductivity (VISCOUS)
    out[CELL_K * nc] =
        conductivity(ph, fl.prim[4 * nc + c] / (ph.R * fl.prim[c]));
  } else {
    double mf[NS];
    double rho = 0.0, rr = 0.0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mf[s] = fl.prim[s * nc + c];
      rho += mf[s];
      rr += sp.R[s] * mf[s];
    }
    const double t = fl.prim[(NS + 3) * nc + c] / rr;
#pragma unroll
    for (int s = 0; s < NS; ++s) mf[s] = mf[s] / rho;
    if constexpr (TP) {
      double cpm, cvm;
      thermo::cp_cv<NS>(sp, mf, t, cpm, cvm);
      out[CELL_GAMMA * nc] = cpm / cvm;
      out[CELL_ENERGY * nc] = thermo::energy<NS>(sp, mf, t);
      if constexpr (VISCOUS) {
        if constexpr (NEQ == NS + 6) out[CELL_CP * nc] = cpm;
        if (sp.diffusion) {
#pragma unroll
          for (int q = 0; q < NS; ++q)
            out[(CELL_H + q) * nc] = thermo::species_enthalpy(sp, q, t);
        }
      }
    }
    if constexpr (VISCOUS)
      out[CELL_K * nc] = mixture_conductivity<NS>(ph, sp, mf, t);
  }
}

template <int NS, int NEQ, bool VISCOUS, bool WILCOX, bool FORWARD>
__global__ void __launch_bounds__(wavefront::PREPASS_THREADS)
    prepass(Fields fl, KernelPhys ph, Mixture<NS> sp,
            wavefront::Schedule sc) {
  if (sc.clocks && threadIdx.x == 0) probe::stamp(sc.clocks, 2);
  const int64_t f = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (f < 3 * fl.ncp) {
    const wavefront::Face fc = wavefront::face_of(sc, f);
#if SWEEP_ROE
#if SWEEP_TP
    tp_state::store_old_energy<NS, NEQ>(fl, sp, fc);
#endif
    if (fl.mask[f]) {
      const wavefront::FaceOperands<NEQ> op =
          wavefront::face_operands<NSTAT, NS, NEQ, VISCOUS, WILCOX, FORWARD>(
              fl, fc, f);
      flux::store_roe_old_terms<NS, NEQ, VISCOUS, WILCOX>(
          ph, sp, op.q, op.qd, op.st[0], op.st[1], op.st[2], op.st[3],
          op.dist, op.mu, op.mut, op.f1, fl.pre + f, 3 * fl.ncp);
#if SWEEP_TP
      tp_state::store_ghost_update<NS, NEQ, FORWARD>(fl, ph, sp, sc, fc,
                                                      op);
#endif
    }
#else
    const int64_t c = wavefront::padded_of(fl, fc);
    if (fc.d == 0) store_cell_terms<NS, NEQ, VISCOUS>(fl, ph, sp, c);
    if (fl.mask[f] && wavefront::ghost_neighbour<FORWARD>(sc, fc))
      store_cell_terms<NS, NEQ, VISCOUS>(
          fl, ph, sp,
          FORWARD ? c - stride_of(fl, fc.d) : c + stride_of(fl, fc.d));
#endif
  }
  if (sc.clocks) {
    __syncthreads();
    if (threadIdx.x == 0) probe::stamp(sc.clocks, 3);
  }
}

#if SWEEP_ROE
// Direction d's Roe product of one cell from the stored terms, added to x
// (x_t keeps its +0.0): the neighbour's q + du (a thermally perfect form
// reads it from qu, the stage's or the pre-pass's, through L2; else formed
// from its state), its new Roe flux with the cell's own state, against
// the pre-pass's old flux, plus the stored radii times du.  Every load is
// issued before the mask is known (a masked face's operands are read but
// not used).
template <int NS, int NEQ, bool VISCOUS, bool FORWARD>
__device__ __forceinline__ void stored_product(const Fields& fl,
                                               const PhysRoe& ph,
                                               const Mixture<NS>& sp,
                                               int64_t c, int64_t pc, int d,
                                               double x[NEQ]) {
  constexpr int NV = flux::roe_face_values<NS, NEQ, VISCOUS>();
  const int64_t f = 3 * pc + d;
  const bool unmasked = fl.mask[f];
  const int64_t nb = FORWARD ? c - stride_of(fl, d) : c + stride_of(fl, d);
  const double* st = fl.stat + f * NSTAT;
  const int64_t P = 3 * fl.ncp;
  double old[NV], qn[NEQ], dq[NEQ];
#pragma unroll
  for (int v = 0; v < NV; ++v) old[v] = __ldg(fl.pre + f + v * P);
#if SWEEP_TP
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    qn[e] = __ldcg(fl.qu + e * fl.nc + nb);
    dq[e] = __ldcg(fl.du + e * fl.nc + nb);
  }
  if (!unmasked) return;
#else
  double q[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    q[e] = fl.prim[e * fl.nc + nb];
    dq[e] = __ldcg(fl.du + e * fl.nc + nb);
  }
  if (!unmasked) return;
  flux::update_state<NS, NEQ>(ph, sp, q, dq, qn);
#endif
  if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS);
  double qd[NEQ], fn[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) qd[e] = fl.prim[e * fl.nc + c];
  flux::roe_new_flux<NS, NEQ, FORWARD>(ph, sp, qn, qd, st[0], st[1], st[2],
                                       fn);
  if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS + 1);
  flux::add_roe_change<NS, NEQ, VISCOUS, FORWARD>(fn, old, st[3], dq, x);
  if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS + 2);
}
#endif  // SWEEP_ROE

// Lane d's rows (i % 3 == d) of one cell's update from the sum acc of its
// three off-diagonal products: the right-hand side, then the rows of the
// inverse product (the plane kernel's update of du).  b, extra, inv_f and
// inv_t do not change during the launch (__ldg).  A row's store of du may
// alias the next row's operands as far as the compiler knows, so each row
// loads after the row before it is stored: one L2 round trip a row.
// LOADS_FIRST loads every row's operands before the first store, one round
// trip in all, for about 2 N ceil(N / 3) more registers through finish:
// the Rusanov and the thermally perfect forms of up to LOADS_FIRST_NS
// species (loads_first).  The thermally perfect Roe forms of three to five
// species have none to spare (with the loads first ptxas spilled 8-88 B at
// 255 registers on sm_90a), nor has a species count above the base
// build's; the calorically perfect Roe forms load row by row.
constexpr int LOADS_FIRST_NS = ROE ? 2 : BASE_NS;
template <int NS>
__host__ __device__ constexpr bool loads_first() {
  return (TP || !ROE) && NS <= LOADS_FIRST_NS;
}

template <int NS, int NEQ, bool FORWARD, bool LOADS_FIRST>
__device__ __forceinline__ void finish_rows(const Fields& fl, int64_t c,
                                            int64_t pc, int d,
                                            const double acc[NEQ]) {
  constexpr int N = NS + 4;
  constexpr int L = wavefront::LANES;
  constexpr int R = (N + L - 1) / L;   // lane d's flow rows i = d + L k
  constexpr bool TURB = NEQ == N + 2;
  const bool plain_backward = !FORWARD && fl.extra == nullptr;
  double bv[NEQ], ev[NEQ], inv[R][N], xin[R + 2], it[4];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    bv[e] = plain_backward ? 0.0 : __ldg(fl.b + e * fl.ncp + pc);
    ev[e] = fl.extra ? __ldg(fl.extra + e * fl.ncp + pc) : 0.0;
  }
  // flow row k's inverse row (and du, plain backward); the turbulence
  // block's rows of this lane
  auto load_row = [&](int k) {
    const int i = d + L * k;
#pragma unroll
    for (int j = 0; j < N; ++j)
      inv[k][j] = __ldg(fl.inv_f + (N * i + j) * fl.ncp + pc);
    if (plain_backward) xin[k] = __ldcg(fl.du + i * fl.nc + c);
  };
  auto load_turbulence = [&]() {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if ((N + t) % L != d) continue;
      it[2 * t] = __ldg(fl.inv_t + 2 * t * fl.ncp + pc);
      it[2 * t + 1] = __ldg(fl.inv_t + (2 * t + 1) * fl.ncp + pc);
      if (plain_backward) xin[R + t] = __ldcg(fl.du + (N + t) * fl.nc + c);
    }
  };
  if constexpr (LOADS_FIRST) {
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (d + L * k < N) load_row(k);
    if constexpr (TURB) load_turbulence();
  }
  // right-hand side the inverse applies to (acc holds the neighbour sum)
  double r[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    r[e] = acc[e];
    if (plain_backward) continue;
    if (FORWARD)
      r[e] = fl.extra ? (bv[e] + r[e]) - ev[e] : bv[e] + r[e];
    else
      r[e] = (bv[e] + ev[e]) - r[e];
  }
  // D^-1 r: the N x N flow block row by row, then the 2x2 turbulence block
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = d + L * k;
    if (i >= N) continue;
    if constexpr (!LOADS_FIRST) load_row(k);
    double y = 0.0;
#pragma unroll
    for (int j = 0; j < N; ++j) y += inv[k][j] * r[j];
    fl.du[i * fl.nc + c] = plain_backward ? xin[k] - y : y;
  }
  if constexpr (TURB) {
    if constexpr (!LOADS_FIRST) load_turbulence();
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if ((N + t) % L != d) continue;
      const double y = it[2 * t] * r[N] + it[2 * t + 1] * r[N + 1];
      fl.du[(N + t) * fl.nc + c] = plain_backward ? xin[R + t] - y : y;
    }
  }
}

// Prefetch into L2 what lane d reads for one cell but du: for a Roe form
// its stored face values in place of the viscous fields and the velocity
// gradient, and the cell's own state (for a thermally perfect one, what
// the stage reads, in place of the neighbour's state: its q + du is
// written during the launch); for a thermally perfect Rusanov form the
// neighbour's stored terms too.
template <int NS, int NEQ, bool VISCOUS, bool WILCOX, bool FORWARD>
__device__ __forceinline__ void prefetch_cell(const Fields& fl, int64_t c,
                                              int64_t pc, int d) {
  constexpr int N = NS + 4;
  using wavefront::prefetch_l2;
  const int64_t nb = FORWARD ? c - stride_of(fl, d) : c + stride_of(fl, d);
  const double* st = fl.stat + (3 * pc + d) * NSTAT;
  prefetch_l2(fl.mask + 3 * pc + d);
  prefetch_l2(st);
  prefetch_l2(st + NSTAT - 1);
  if constexpr (!STAGED) {
#pragma unroll
    for (int e = 0; e < NEQ; ++e) prefetch_l2(fl.prim + e * fl.nc + nb);
  }
  if constexpr (ROE) {
#pragma unroll
    for (int e = 0; e < NEQ; ++e) prefetch_l2(fl.prim + e * fl.nc + c);
    constexpr int NV = flux::roe_face_values<NS, NEQ, VISCOUS>();
#pragma unroll
    for (int v = 0; v < NV; ++v)
      prefetch_l2(fl.pre + 3 * pc + d + v * 3 * fl.ncp);
#if SWEEP_TP
    if (d == 0) prefetch_l2(fl.eold + pc);
#endif
  } else if constexpr (VISCOUS) {
    prefetch_l2(fl.mu + nb);
    prefetch_l2(fl.mut + nb);
    if constexpr (NEQ == N + 2 && !WILCOX) prefetch_l2(fl.f1 + nb);
#pragma unroll
    for (int g = 0; g < 9; ++g) prefetch_l2(fl.vgrad + g * fl.nc + nb);
  }
  if constexpr (!ROE) {
    if constexpr (VISCOUS) prefetch_l2(fl.pre + CELL_K * fl.nc + nb);
    if constexpr (TP) {
      prefetch_l2(fl.pre + CELL_GAMMA * fl.nc + nb);
      prefetch_l2(fl.pre + CELL_ENERGY * fl.nc + nb);
      if constexpr (NEQ == N + 2) prefetch_l2(fl.pre + CELL_CP * fl.nc + nb);
    }
  }
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    if (e % wavefront::LANES != d) continue;
    prefetch_l2(fl.b + e * fl.ncp + pc);
    if (fl.extra) prefetch_l2(fl.extra + e * fl.ncp + pc);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i % wavefront::LANES != d) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) prefetch_l2(fl.inv_f + (N * i + j) * fl.ncp + pc);
  }
  if constexpr (NEQ == N + 2) {
#pragma unroll
    for (int x = 0; x < 4; ++x) prefetch_l2(fl.inv_t + x * fl.ncp + pc);
  }
}

// one whole sweep of one block on persistent CTAs, with the thermally
// perfect Roe forms' stage (sweep_wavefront.cuh)
template <int NS, int NEQ, bool VISCOUS, bool WILCOX, bool FORWARD>
__global__ void __launch_bounds__(wavefront::THREADS, 1)
    sweep_tiles(Fields fl, KernelPhys ph, Mixture<NS> sp,
                wavefront::Schedule sc) {
  const int nj = sc.n[1], nk = sc.n[2];
  auto padded = [&](int i, int j, int k) {
    return fl.base + i * fl.stride[0] + j * fl.stride[1] + k * fl.stride[2];
  };
  auto physical = [&](int i, int j, int k) {
    return (static_cast<int64_t>(i) * nj + j) * nk + k;
  };
  auto prefetch = [&](int i, int j, int k, int d) {
    prefetch_cell<NS, NEQ, VISCOUS, WILCOX, FORWARD>(fl, padded(i, j, k),
                                                     physical(i, j, k), d);
  };
  auto addends = [&](int i, int j, int k, int d, double (&x)[2][NEQ]) {
#if SWEEP_ROE
    stored_product<NS, NEQ, VISCOUS, FORWARD>(fl, ph, sp, padded(i, j, k),
                                              physical(i, j, k), d, x[0]);
#else
    direction_product<NS, NEQ, VISCOUS, WILCOX, FORWARD>(
        fl, ph, sp, padded(i, j, k), physical(i, j, k), d, x[0], x[1]);
#endif
  };
  auto finish = [&](int i, int j, int k, int d, const double (&acc)[NEQ]) {
    finish_rows<NS, NEQ, FORWARD, loads_first<NS>()>(
        fl, padded(i, j, k), physical(i, j, k), d, acc);
  };
#if SWEEP_ROE && SWEEP_TP
  wavefront::walk<FORWARD, NEQ, 2, SWEEP_PROBE != 0, thermo::SPEC_LANES>(
      sc, prefetch, addends, finish,
      [&](int i, int j, int k, int r, unsigned group) {
        tp_state::invert_cell<NS, NEQ, SWEEP_PROBE != 0>(
            fl, ph, sp, padded(i, j, k), physical(i, j, k), r, group);
      });
#else
  wavefront::walk<FORWARD, NEQ, 2, SWEEP_PROBE != 0>(sc, prefetch, addends,
                                                     finish);
#endif
}

// a form's pre-pass (split()) and its persistent wavefront, a thermally
// perfect Roe form's with its stage (the work space: a Roe form's 3 ncp
// faces of flux::roe_face_values each, then for a thermally perfect one
// its old energies and updated states, tp_state.cuh tp_state_space; a
// Rusanov form's nc cells of the CELL_* terms; null for an inviscid
// calorically perfect Rusanov form, which has no pre-pass)
template <int NS, int NEQ, bool VISCOUS, bool WILCOX>
int launch_tiles(int forward, Fields fl, const PhysRoe& ph_all,
                 const Mixture<NS>& sp, const wavefront::Schedule& sc,
                 cudaStream_t st, double* work) {
  const KernelPhys& ph = ph_all;
  if ((work != nullptr) != split<VISCOUS>())
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (split<VISCOUS>()) {
    fl.pre = work;
#if SWEEP_ROE && SWEEP_TP
    tp_state::tp_state_space(
        fl, work + flux::roe_face_values<NS, NEQ, VISCOUS>() * 3 * fl.ncp);
#endif
    const int err =
        forward
            ? wavefront::launch_cells(prepass<NS, NEQ, VISCOUS, WILCOX, true>,
                                      3 * fl.ncp, wavefront::PREPASS_THREADS,
                                      st, fl, ph, sp, sc)
            : wavefront::launch_cells(
                  prepass<NS, NEQ, VISCOUS, WILCOX, false>, 3 * fl.ncp,
                  wavefront::PREPASS_THREADS, st, fl, ph, sp, sc);
    if (err != 0) return err;
  }
  // the thermally perfect Roe forms' stage: thermo::SPEC_LANES threads a
  // cell
  constexpr int lanes = STAGED ? thermo::SPEC_LANES : 0;
  if (forward)
    return wavefront::launch_lanes(
        lanes, sweep_tiles<NS, NEQ, VISCOUS, WILCOX, true>, sc, st, fl, ph,
        sp);
  return wavefront::launch_lanes(
      lanes, sweep_tiles<NS, NEQ, VISCOUS, WILCOX, false>, sc, st, fl, ph,
      sp);
}

// the four forms of one species count; species holds R_s, cv_s, cp_s,
// hf_s, cond_c1_s, cond_s_s and the molar masses (NS each), then the
// Schmidt number, the turbulent Schmidt number and the diffusion flag,
// then for the thermally perfect forms the species' mode counts (NS) and
// their temperatures (thermo::read_vib)
template <int NS>
int launch_form(int forward, int neq, int viscous, int wilcox,
                const Fields& fl, const PhysRoe& ph, const double* species,
                const wavefront::Schedule& sc, cudaStream_t st,
                double* work) {
  constexpr int N = NS + 4;
  Mixture<NS> sp;
  for (int s = 0; s < NS; ++s) {
    sp.R[s] = species[s];
    sp.cv[s] = species[NS + s];
    sp.cp[s] = species[2 * NS + s];
    sp.hf[s] = species[3 * NS + s];
    sp.cond_c1[s] = species[4 * NS + s];
    sp.cond_s[s] = species[5 * NS + s];
    sp.mm[s] = species[6 * NS + s];
  }
  sp.schmidt = species[7 * NS];
  sp.turb_schmidt = species[7 * NS + 1];
  sp.diffusion = species[7 * NS + 2] != 0.0;
#if SWEEP_TP
  if (!thermo::read_vib<NS>(species + 7 * NS + 3, sp.vib))
    return static_cast<int>(cudaErrorInvalidValue);
#endif
  static_assert(sizeof(Fields) + sizeof(KernelPhys) + sizeof(Mixture<NS>) +
                        sizeof(wavefront::Schedule) <= 4096,
                "the kernels' parameters exceed 4 KB");
  if (neq == N && !viscous && !wilcox)
    return launch_tiles<NS, N, false, false>(forward, fl, ph, sp, sc, st,
                                             work);
  if (neq == N && viscous && !wilcox)
    return launch_tiles<NS, N, true, false>(forward, fl, ph, sp, sc, st,
                                            work);
  if (neq == N + 2 && viscous && !wilcox)
    return launch_tiles<NS, N + 2, true, false>(forward, fl, ph, sp, sc, st,
                                                work);
  if (neq == N + 2 && viscous && wilcox)
    return launch_tiles<NS, N + 2, true, true>(forward, fl, ph, sp, sc, st,
                                               work);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One whole block sweep of one block: a cudaMemsetAsync of the schedule's
// state, for the pre-pass forms (split()) the pre-pass, and one
// tile-wavefront launch, all on `stream`.  ns is 1..BASE_NS, or SWEEP_NS in
// a build for that count, and neq is ns + 4 or ns + 6; viscous and wilcox
// select the form (see the head of this file); roe is 1 for the approximateRoe forms, which only
// the library built with SWEEP_ROE holds (they read prandtl, tmin_k and
// tmin_w, and no vgrad); tp is 1 for the thermally perfect forms, which
// only the library built with SWEEP_TP holds.  R, cv, cp, hf, gamma,
// prandtl, cond_c1 and cond_s are the one species' (read when ns is 1 by
// the calorically perfect forms); species is a HOST array of the
// mixture's constants (launch_form; read when ns > 1 or tp).  stat and
// mask are in physical cell order; sched is a HOST array {ntiles, ni, nj,
// nk, ti, tj, tk, g, ctas} (ctas: the wavefront's persistent CTAs), tiles
// the device tile table and state device scratch of 1 + ntiles ints
// (sweep_wavefront.cuh).  extra may be null; mu, mut, f1,
// vgrad may be null when inviscid and inv_t without turbulence equations.
// work is the pre-pass forms' device work space (null for the other
// forms, launch_tiles; kernels/lusgs_sweep.py work_doubles); clocks null,
// or in the probe's build (SWEEP_PROBE) the device array of the step
// clocks (sweep_wavefront.cuh, namespace probe).
// Returns cudaGetLastError() after the launches (0 when they were
// accepted), or cudaErrorInvalidValue for a form that does not exist or
// that another library holds.
extern "C" int blusgs_sweep_f64(
    int forward, int ns, int neq, int viscous, int wilcox, int roe, int tp,
    const double* prim,
    double* du, const double* mu, const double* mut, const double* f1,
    const double* vgrad, const double* b, const double* extra,
    const double* inv_f, const double* inv_t, const double* stat,
    const unsigned char* mask, long long nc, long long ncp, long long stride_i,
    long long stride_j, long long stride_k, const int* sched, const int* tiles,
    int* state, double R, double cv, double cp, double hf, double gamma,
    double prandtl, double prt, double scaling, double tmin_k, double tmin_w,
    double t_ref, double cond_c1, double cond_s, double k_nondim,
    double sigma_k1, double sigma_k2, double sigma_w1, double sigma_w2,
    const double* species, void* stream, double* work,
    unsigned long long* clocks) {
  if ((roe != 0) != ROE || (tp != 0) != TP ||
      (clocks && !SWEEP_PROBE))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t base = sched[7] * (stride_i + stride_j + stride_k);
  Fields fl{prim,  du,    mu,    mut,  f1,   vgrad, b,   extra,
            inv_f, inv_t, stat,  mask, nc,   ncp,   base,
            {stride_i, stride_j, stride_k}, nullptr};
  PhysRoe ph{{R, cv, cp, hf, gamma, prt, scaling, t_ref, cond_c1, cond_s,
              k_nondim, sigma_k1, sigma_k2, sigma_w1, sigma_w2},
             prandtl, tmin_k, tmin_w};
  const wavefront::Schedule sc =
      wavefront::make_schedule(sched, tiles, state, clocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#ifdef SWEEP_NS
  static_assert(SWEEP_NS > BASE_NS, "a SWEEP_NS build is of a count above "
                                    "the base build's");
  if (ns == SWEEP_NS)
    return launch_form<SWEEP_NS>(forward, neq, viscous, wilcox, fl, ph,
                                 species, sc, st, work);
#else
  switch (ns) {
    case 1:
      return launch_form<1>(forward, neq, viscous, wilcox, fl, ph, species,
                            sc, st, work);
    case 2:
      return launch_form<2>(forward, neq, viscous, wilcox, fl, ph, species,
                            sc, st, work);
    case 3:
      return launch_form<3>(forward, neq, viscous, wilcox, fl, ph, species,
                            sc, st, work);
    case 4:
      return launch_form<4>(forward, neq, viscous, wilcox, fl, ph, species,
                            sc, st, work);
    case BASE_NS:
      return launch_form<BASE_NS>(forward, neq, viscous, wilcox, fl, ph,
                                  species, sc, st, work);
  }
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}
