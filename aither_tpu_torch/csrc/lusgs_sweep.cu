// LU-SGS hyperplane sweep for NVIDIA Hopper (sm_90a), float64.
//
// Replaces the TPU kernel aither_tpu/solver/pallas_sweep.py::sweep
// (pallas_call at pallas_sweep.py:342), variants (a) and (b): scalar
// LU-SGS, Rusanov off-diagonal, without and with the lagged opposite-side
// term `extra` (matrixSweeps > 1, pallas_sweep.py:315-324), for one
// species or a mixture of any count NS (a build holds NS = 1..BASE_NS, or
// with -DSWEEP_NS=N one count N > BASE_NS: the library <name>_ns<N>, built
// when a deck first needs it), in the forms the models need, each a
// compile-time instantiation of one
// sweep_tiles<NS, NEQ, VISCOUS, WILCOX, FORWARD> with NEQ = NS + 4
// (+ 2 turbulence equations, the first at NS + 4):
//   NS + 4 equations inviscid (Euler): spectral radius 0.5|A|(|v.n| + a)
//     only; mu, mut, f1 and the centre distance are not read;
//   NS + 4 equations viscous (laminar with mut = 0; LES with the WALE mut
//     in mu/Pr + mut/Prt); f1 is not read;
//   NS + 6 equations SST 2003 / SST-DES: the turbulence viscous radius
//     with the mut field and the blended sigma_k;
//   NS + 6 equations Wilcox 2006: that radius with sigma* constant and the
//     unlimited rho k / omega of the neighbour state, not the mut field.
// Without turbulence equations inv_t is null.  One species (NS = 1) keeps
// the constant gamma and Prandtl number of its gas; a mixture takes its
// per-species constants (R_s, cv_s, cp_s, hf_s: struct Species) and
// evaluates the mixture per state, as the JAX package's Physics does:
// T = p / sum R_s rho_s, gamma = sum mf_s cp_s / sum mf_s cv_s, the
// laminar Prandtl number 4 gamma / (9 gamma - 5) of the neighbour state,
// and in q + du the species renormalisation mf_s = max(c_s / r, 0) / sum
// (aither_tpu state.py:40-90).
//
// ROE selects the off-diagonal of `inviscidFluxJacobian: approximateRoe`
// (roe_offdiag.cuh: the Roe flux change with the cell's own state held
// fixed, plus the viscous-only radii), which replaces the JAX package's
// scan path of aither_tpu/solver/implicit.py:113 roe_offdiagonal (no
// Pallas form there).  A build holds the Rusanov forms (this file as it
// is, library lusgs_sweep) or, with -DSWEEP_ROE=1, the Roe forms (library
// lusgs_sweep_roe): two translation units, built in parallel.
//
// Every form splits the product (the section "The pre-pass forms"
// below): a pre-pass launch stores, once per face, the old-state terms
// (Rusanov: the old flux F(q).n and the radii, rusanov_old_terms; Roe: the
// old Roe flux and the radii, roe_offdiag.cuh store_roe_old_terms), the
// wavefront's lanes evaluate only the new flux of q + du (closed form for
// a calorically perfect gas) against them, and the wavefront runs on
// persistent CTAs.
//
// A build with -DSWEEP_TP=1 (library lusgs_sweep_tp) holds the thermally
// perfect forms (thermodynamicModel: thermallyPerfect) of the Rusanov
// off-diagonal, and with -DSWEEP_ROE=1 as well (lusgs_sweep_roe_tp) those
// of the Roe off-diagonal (roe_offdiag.cuh): every species count takes the
// mixture path, one species with mass fraction 1, and each species' energy,
// enthalpy, cv and cp are functions of T (thermo_tp.cuh, struct
// Species's vibrational table): the neighbour's gamma and Prandtl number
// from its T, the energy of q + du inverted by Ridder's method
// (roe_offdiag.cuh update_prim_mix_from), which replaces the JAX package's
// scan sweep of such a deck (pallas_sweep.use_pallas turns its kernel
// off there: aither_tpu/solver/implicit.py:89, 137 through
// state.update_prim_with_cons and the thermally perfect Physics).  The
// constant gamma and Prandtl number of Phys are not read.  A stage of
// their wavefront inverts each updated state once, where a calorically
// perfect lane forms the neighbour's q + du in closed form.
//
// What it computes (reference: linearSolver.cpp:341-428): for every
// hyperplane p = i+j+k in order (forward: increasing p, backward:
// decreasing), every physical cell c of the plane becomes
//   forward:  du[c] = D^-1 (b[c] + sum_d L_d [- extra[c]])
//   backward: du[c] = du[c] - D^-1 sum_d U_d
//             or, with extra, D^-1 (b[c] + extra[c] - sum_d U_d)
// extra is the previous sweep's opposite-side sum (upper for the forward
// sweep, lower for the backward one), computed before the sweep on the
// host side (aither_tpu_torch/solver/implicit.py offdiag_sum).
// where L_d / U_d is the scalar Rusanov off-diagonal product of the lower /
// upper neighbour across direction d (aither_tpu implicit.offdiagonal_scalar:
// the flux change 0.5|A|(F(q+du)-F(q)).n with turbulence rows zeroed, plus
// the inviscid, viscous and turbulence face spectral radii times du), or
// the Roe product (ROE).  The
// neighbour in the block interior is final once its plane is done; a
// neighbour in a connection ghost holds the swapped du.  du is updated IN
// PLACE: a plane reads only the plane before it.
//
// Schedule: a pre-pass launch and one wavefront launch per block and
// sweep, the tile wavefront of sweep_wavefront.cuh (tiles in a topological
// order taken from an atomic ticket by persistent CTAs, a tile's local
// planes separated by __syncthreads(), progress flags between tiles, three
// lanes per cell, one per direction).  Each cell's arithmetic is the plane
// kernel's: the three directions' products (stored_product) summed from
// 0.0 in the order i, j, k, the diagonal last (finish_loaded or
// finish_rows).
//
// Layout: prim, du (NEQ, NI, NJ, NK) and mu, mut, f1 (NI, NJ, NK) padded
// blocks; b, extra (NEQ, ni, nj, nk), inv_f, inv_t (ni, nj, nk) physical;
// per physical cell and direction the face normal, area and centre
// distance (stat, 15 doubles) and whether the neighbour contributes
// (mask), in physical cell order (solver/implicit.py SweepPlan).  A
// masked face is skipped by a branch, never multiplied by zero: a ghost
// state there may be garbage and 0*NaN is NaN.
//
// What bounds it on the card: at 1M cells the bytes a forward+backward pair
// must move take well under 1 ms at 3.35 TB/s (kernels/lusgs_sweep.py
// sweep_cost; PERF.md).  The sweep is a chain of ni+nj+nk-2 dependent
// planes of a few hundred to a few thousand cells each, so what holds it
// is the time of one step of the chain: a barrier, the flags between
// tiles and one cell's serial FP64 work (q + du and the new flux, Rusanov
// or Roe, the old-state terms stored by the pre-pass; for a thermally
// perfect gas the new flux, then the stage's Ridder inversion of the
// cell's q + du, about 20 dependent energy evaluations).  The
// plane-per-launch kernel took ~20 us a step; the wavefront takes the
// launch out of it and splits the cell's work over three lanes, and the
// pre-pass takes the old state's terms off the chain (PERF.md, section
// 6).  From about 8 species
// on the per-thread arrays (q, du, the fluxes: NS + 6 doubles each) spill
// to local memory; the species constants pass by value, under the classic
// 4 KB of kernel parameters at 16 species with a thermally perfect gas's
// table of up to 256 vibrational modes (thermo_tp.cuh; utils/build.py
// resolves a library's name into this source and its defines).

#include <cuda_runtime.h>

#include <cstdint>

#include "roe_offdiag.cuh"
#include "sweep_wavefront.cuh"
#include "tp_state.cuh"

// 1: this translation unit holds the approximateRoe forms (the library
// lusgs_sweep_roe, utils/build.py VARIANTS), 0: the Rusanov forms
#ifndef SWEEP_ROE
#define SWEEP_ROE 0
#endif
// 1: the forms carry the step clocks' marks (sweep_wavefront.cuh,
// namespace probe): only the build of the probe, library <name>_probe, for
// utils/sweep_probe.py (they cost 1-3% of a sweep pair, with or without
// clocks)
#ifndef SWEEP_PROBE
#define SWEEP_PROBE 0
#endif

namespace {

using flux::physical_flux;
using flux::physical_flux_mix;

constexpr int NSTAT = 5;       // nx, ny, nz, mag, dist per direction
// species counts of a build without SWEEP_NS: 1..BASE_NS
constexpr int BASE_NS = 5;

struct Phys {
  double R, cv, cp, hf, gamma, prandtl, prt, scaling;
  double tmin_k, tmin_w;
  double sigma_k1, sigma_k2;  // SST blend; Wilcox: sigma* in sigma_k1
};

// the forms of this translation unit: the thermally perfect gas, the
// approximateRoe off-diagonal
constexpr bool TP = SWEEP_TP != 0;
constexpr bool ROE = SWEEP_ROE != 0;

// per-species constants of a mixture (read when NS > 1, and for every NS
// by the thermally perfect forms)
template <int NS>
struct Species {
  double R[NS], cv[NS], cp[NS], hf[NS];
#if SWEEP_TP
  thermo::Vib<NS> vib;
#endif
};

struct Fields {
  const double* __restrict__ prim;
  double* du;        // written by other SMs during the launch: __ldcg only
  const double* __restrict__ mu;
  const double* __restrict__ mut;
  const double* __restrict__ f1;
  const double* __restrict__ b;
  const double* __restrict__ extra;  // nullptr: no lagged term
  const double* __restrict__ inv_f;
  const double* __restrict__ inv_t;
  const double* __restrict__ stat;   // physical cell order
  const unsigned char* __restrict__ mask;
  int64_t nc;        // NI*NJ*NK: equation stride of the padded fields
  int64_t ncp;       // ni*nj*nk: equation stride of b
  int64_t base;      // padded flat index of physical cell (0, 0, 0)
  int64_t stride[3]; // flat step of one cell in i, j, k
  // the work space (launch_tiles): the pre-pass writes pre (and eold) and
  // the wavefront reads them (__ldg); a thermally perfect form's qu is
  // written by the pre-pass (ghost neighbours) and by the wavefront's stage
  // (physical cells), which reads it through L2 (__ldcg)
  double* pre;       // (face_values, 3 ncp): per face the old-state terms
#if SWEEP_TP
  double* eold;      // (ncp): q's specific total energy
  double* qu;        // (NEQ, nc): q + du in primitive variables
#endif
};

// values the pre-pass stores per face: Rusanov, the flow rows of F(q).n,
// the face radius and (with turbulence equations) the turbulence radius;
// Roe, the NEQ rows of F_roe(q | q_cell) and the
// viscous radii (flux::roe_face_values)
template <int NS, int NEQ, bool VISCOUS>
__host__ __device__ constexpr int face_values() {
  constexpr int nturb = NEQ - NS - 4;
  return ROE ? flux::roe_face_values<NS, NEQ, VISCOUS>()
             : NS + 5 + nturb / 2;
}

// the old-state terms of a neighbour's scalar Rusanov product that the
// pre-pass stores (aither_tpu implicit.offdiagonal_scalar): F(q).n, the face spectral radius sr
// (inviscid, plus the viscous one when VISCOUS) and the turbulence radius
// sr_t (with turbulence equations).  mu, mut, f1 and dist are read only by
// the forms that use them (the caller passes 0 otherwise).
template <int NS, int NEQ, bool VISCOUS, bool WILCOX, bool FORWARD>
__device__ __forceinline__ void rusanov_old_terms(
    const Phys& ph, const Species<NS>& sp, const double q[NEQ], double n0,
    double n1, double n2, double mag, double dist, double mu, double mut,
    double f1, double fq[NEQ], double& sr, double& sr_t) {
  constexpr int T0 = NS + 4;   // first turbulence equation
  double rho, vn, gamma, prandtl;
  if constexpr (NS == 1 && !TP) {
    physical_flux<NEQ>(ph, q, n0, n1, n2, fq);
    rho = q[0];
    vn = q[1] * n0 + q[2] * n1 + q[3] * n2;
    gamma = ph.gamma;
    prandtl = ph.prandtl;
  } else {
    physical_flux_mix<NS, NEQ>(sp, q, n0, n1, n2, fq);
    rho = 0.0;
    double cpm = 0.0, cvm = 0.0;
#pragma unroll
    for (int s = 0; s < NS; ++s) rho += q[s];
    if constexpr (TP) {
      double mf[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) mf[s] = q[s] / rho;
      thermo::cp_cv<NS>(sp, mf, q[NS + 3] / flux::species_sum<NS>(sp.R, q),
                        cpm, cvm);
    } else {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        cpm += sp.cp[s] * (q[s] / rho);
        cvm += sp.cv[s] * (q[s] / rho);
      }
    }
    vn = q[NS] * n0 + q[NS + 1] * n1 + q[NS + 2] * n2;
    gamma = cpm / cvm;
    prandtl = 4.0 * gamma / (9.0 * gamma - 5.0);
  }
  const double a = sqrt(gamma * q[NS + 3] / rho);
  sr = 0.5 * mag * (fabs(vn) + a);
  if constexpr (VISCOUS) {
    const double max_term = fmax(4.0 / (3.0 * rho), gamma / rho);
    sr = sr + mag / dist * max_term *
                  (ph.scaling * (mu / prandtl + mut / ph.prt));
  }
  sr_t = 0.0;
  if constexpr (NEQ == T0 + 2) {
    sr_t = 0.5 * mag * fabs(FORWARD ? vn + fabs(vn) : vn - fabs(vn));
    if constexpr (VISCOUS) {
      // Wilcox: sigma* and the unlimited eddy viscosity of the neighbour
      const double sk = WILCOX ? ph.sigma_k1
                               : f1 * ph.sigma_k1 + (1.0 - f1) * ph.sigma_k2;
      const double mutx = WILCOX ? rho * q[T0] / q[T0 + 1] : mut;
      sr_t = sr_t + ph.scaling * (mag / dist) / rho * (mu + sk * mutx);
    }
  }
}

// The rows of the scalar Rusanov product from the new flux fu = F(q +
// du).n and the old-state terms: the flow rows 0.5 |A| (fu - fq) +- sr du
// (fq: F(q).n's flow rows), the turbulence rows +- sr_t du (their flux
// change zeroed), added to acc.
template <int NS, int NEQ, bool FORWARD>
__device__ __forceinline__ void add_rusanov_rows(const double fu[NEQ],
                                                 const double fq[],
                                                 double mag, double sr,
                                                 double sr_t,
                                                 const double dq[NEQ],
                                                 double acc[NEQ]) {
  constexpr int T0 = NS + 4;   // first turbulence equation
  const double sgn = FORWARD ? 1.0 : -1.0;
#pragma unroll
  for (int e = 0; e < T0; ++e)
    acc[e] += 0.5 * mag * (fu[e] - fq[e]) + sgn * (sr * dq[e]);
#pragma unroll
  for (int e = T0; e < NEQ; ++e) acc[e] += sgn * (sr_t * dq[e]);
}

using wavefront::stride_of;
using wavefront::viscous_fields;

// Lane d's rows (e % 3 == d) of one cell's update from the sum acc of its
// three off-diagonal products (the plane kernel's update of du).
template <int NS, int NEQ, bool FORWARD>
__device__ __forceinline__ void finish_rows(const Fields& fl, int64_t c,
                                            int64_t pc, int d,
                                            const double acc[NEQ]) {
  constexpr int T0 = NS + 4;
  const double inv_f = fl.inv_f[pc];
  double inv_t = 0.0;
  if constexpr (NEQ == T0 + 2) inv_t = fl.inv_t[pc];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    if (e % wavefront::LANES != d) continue;
    const double inv = e < T0 ? inv_f : inv_t;
    double* x = fl.du + e * fl.nc + c;
    const double b = fl.b[e * fl.ncp + pc];
    if (FORWARD)
      *x = (fl.extra ? (b + acc[e]) - fl.extra[e * fl.ncp + pc]
                     : b + acc[e]) * inv;
    else if (fl.extra)
      *x = (b + fl.extra[e * fl.ncp + pc] - acc[e]) * inv;
    else
      *x = __ldcg(x) - acc[e] * inv;
  }
}

// ---------------------------------------------------------------------------
// The pre-pass forms, every form of this file.
// Nothing of the old state changes during a sweep, so a pre-pass (one
// thread per face, fully parallel) evaluates once what the product needs
// of it: per unmasked face of the sweep side the old flux F(q_nb).n
// (Rusanov) or F_roe(q_nb | q_cell) (Roe) and the radii, and for a
// thermally perfect gas per physical cell its old energy and per ghost
// neighbour (its du swapped before the launch) q + du.  The wavefront's
// lanes then evaluate only the new flux of each neighbour's q + du: a
// calorically perfect lane forms q + du itself (closed form), a thermally
// perfect one reads it, since a stage after finish inverts each cell's q
// + du once: a group of thermo::SPEC_LANES threads per cell of the plane,
// its energy by Ridder's method (temperature_from_energy_spec), written to
// qu before the tile publishes the plane (tp_state.cuh: the old energies,
// the ghosts' q + du and the stage, shared with the block sweep's
// thermally perfect approximateRoe forms).  The CTAs are persistent
// (sweep_wavefront.cuh launch_lanes).  The product is the one-lane
// kernel's arithmetic on the stored operands (up to FMA contraction), its
// sum in the one-lane kernel's order: i, j, k, then the diagonal.

// one face 3 pc + d of the pre-pass (head of this section)
template <int NS, int NEQ, bool VISCOUS, bool WILCOX, bool FORWARD>
__device__ __forceinline__ void prepass_face(const Fields& fl, const Phys& ph,
                                             const Species<NS>& sp,
                                             const wavefront::Schedule& sc,
                                             int64_t f) {
  const wavefront::Face fc = wavefront::face_of(sc, f);
#if SWEEP_TP
  tp_state::store_old_energy<NS, NEQ>(fl, sp, fc);
#endif
  if (!fl.mask[f]) return;
  const wavefront::FaceOperands<NEQ> op =
      wavefront::face_operands<NSTAT, NS, NEQ, VISCOUS, WILCOX, FORWARD>(
          fl, fc, f);
  const double* st = op.st;
  const int64_t P = 3 * fl.ncp;   // the stride of a face value
  double* out = fl.pre + f;
  if constexpr (ROE) {
    flux::store_roe_old_terms<NS, NEQ, VISCOUS, WILCOX>(
        ph, sp, op.q, op.qd, st[0], st[1], st[2], st[3], op.dist, op.mu,
        op.mut, op.f1, out, P);
  } else {
    constexpr int T0 = NS + 4;
    double fq[NEQ], sr, sr_t;
    rusanov_old_terms<NS, NEQ, VISCOUS, WILCOX, FORWARD>(
        ph, sp, op.q, st[0], st[1], st[2], st[3], op.dist, op.mu, op.mut,
        op.f1, fq, sr, sr_t);
#pragma unroll
    for (int e = 0; e < T0; ++e) out[e * P] = fq[e];
    out[T0 * P] = sr;
    if constexpr (NEQ == T0 + 2) out[(T0 + 1) * P] = sr_t;
  }
#if SWEEP_TP
  tp_state::store_ghost_update<NS, NEQ, FORWARD>(fl, ph, sp, sc, fc, op);
#endif
}

template <int NS, int NEQ, bool VISCOUS, bool WILCOX, bool FORWARD>
__global__ void __launch_bounds__(wavefront::PREPASS_THREADS)
    prepass(Fields fl, Phys ph, Species<NS> sp, wavefront::Schedule sc) {
  if (sc.clocks && threadIdx.x == 0) probe::stamp(sc.clocks, 2);
  const int64_t f = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (f < 3 * fl.ncp)
    prepass_face<NS, NEQ, VISCOUS, WILCOX, FORWARD>(fl, ph, sp, sc, f);
  if (sc.clocks) {
    __syncthreads();
    if (threadIdx.x == 0) probe::stamp(sc.clocks, 3);
  }
}

// the operands lane d's finish reads for one cell, loaded before its
// product so that their latency hides behind it: per row e = d + 3 r the
// right-hand side, the lagged term or (backward, without it) du's input,
// and the inverse
template <int NEQ>
struct FinishRows {
  static constexpr int R = (NEQ + wavefront::LANES - 1) / wavefront::LANES;
  double b[R], x[R], inv[R];
};

template <int NS, int NEQ, bool FORWARD>
__device__ __forceinline__ void load_finish(const Fields& fl, int64_t c,
                                            int64_t pc, int d,
                                            FinishRows<NEQ>& fr) {
  constexpr int T0 = NS + 4;
  const double inv_f = fl.inv_f[pc];
  double inv_t = 0.0;
  if constexpr (NEQ == T0 + 2) inv_t = fl.inv_t[pc];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    if (e % wavefront::LANES != d) continue;
    const int r = e / wavefront::LANES;
    fr.inv[r] = e < T0 ? inv_f : inv_t;
    fr.b[r] = fl.b[e * fl.ncp + pc];
    if (fl.extra)
      fr.x[r] = fl.extra[e * fl.ncp + pc];
    else if (!FORWARD)
      fr.x[r] = __ldcg(fl.du + e * fl.nc + c);
  }
}

// finish_rows on the loaded operands (the same arithmetic)
template <int NS, int NEQ, bool FORWARD>
__device__ __forceinline__ void finish_loaded(const Fields& fl, int64_t c,
                                              int d, const double acc[NEQ],
                                              const FinishRows<NEQ>& fr) {
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    if (e % wavefront::LANES != d) continue;
    const int r = e / wavefront::LANES;
    const double b = fr.b[r], inv = fr.inv[r];
    double* x = fl.du + e * fl.nc + c;
    if (FORWARD)
      *x = (fl.extra ? (b + acc[e]) - fr.x[r] : b + acc[e]) * inv;
    else if (fl.extra)
      *x = (b + fr.x[r] - acc[e]) * inv;
    else
      *x = fr.x[r] - acc[e] * inv;
  }
}

// Direction d's product from the stored terms (head of this section):
// the neighbour's du through L2 and its q + du (a thermally perfect form's
// qu, through L2; else formed from its state), the new flux F(qu).n, or
// the Roe flux with the cell's own state, against the pre-pass's old flux,
// plus the stored radii times du.  A masked face adds nothing.
template <int NS, int NEQ, bool VISCOUS, bool FORWARD>
__device__ __forceinline__ void stored_product(const Fields& fl,
                                               const Phys& ph,
                                               const Species<NS>& sp,
                                               int64_t c, int64_t pc, int d,
                                               double x[NEQ]) {
  constexpr int NV = face_values<NS, NEQ, VISCOUS>();
  // every load is issued before the mask is known: a masked face's
  // operands are read (the work space and the padded fields hold the
  // face's cells) but not used
  const int64_t f = 3 * pc + d;
  const bool unmasked = fl.mask[f];
  const int64_t nb = FORWARD ? c - stride_of(fl, d) : c + stride_of(fl, d);
  const double* st = fl.stat + f * NSTAT;
  const int64_t P = 3 * fl.ncp;
  double old[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) old[v] = __ldg(fl.pre + f + v * P);
  double qn[NEQ], dq[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
#if SWEEP_TP
    qn[e] = __ldcg(fl.qu + e * fl.nc + nb);
#else
    qn[e] = fl.prim[e * fl.nc + nb];
#endif
    dq[e] = __ldcg(fl.du + e * fl.nc + nb);
  }
  const double mag = st[3];
  if (!unmasked) return;
  if constexpr (!TP) {
    // the calorically perfect q + du, closed form
    double q[NEQ];
#pragma unroll
    for (int e = 0; e < NEQ; ++e) q[e] = qn[e];
    flux::update_state<NS, NEQ>(ph, sp, q, dq, qn);
  }
  if constexpr (ROE) {
    double qd[NEQ], df[NEQ];
#pragma unroll
    for (int e = 0; e < NEQ; ++e) qd[e] = fl.prim[e * fl.nc + c];
    flux::roe_new_flux<NS, NEQ, FORWARD>(ph, sp, qn, qd, st[0], st[1],
                                         st[2], df);
    if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS);
    flux::add_roe_change<NS, NEQ, VISCOUS, FORWARD>(df, old, mag, dq, x);
  } else {
    constexpr int T0 = NS + 4;
    double fu[NEQ];
    flux::state_flux<NS, NEQ>(ph, sp, qn, st[0], st[1], st[2], fu);
    if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS);
    add_rusanov_rows<NS, NEQ, FORWARD>(fu, old, mag, old[T0],
                                       NEQ == T0 + 2 ? old[NV - 1] : 0.0, dq,
                                       x);
  }
  if constexpr (SWEEP_PROBE != 0) probe::mark(probe::ADDENDS + 1);
}

// Prefetch into L2 what lane d reads for one cell but du and qu: for a
// calorically perfect form the neighbour's state, and for lane 0 of a
// thermally perfect one what the stage reads of the cell.
template <int NS, int NEQ, bool VISCOUS, bool FORWARD>
__device__ __forceinline__ void prefetch_stored(const Fields& fl, int64_t c,
                                                int64_t pc, int d) {
  constexpr int T0 = NS + 4;
  constexpr int NV = face_values<NS, NEQ, VISCOUS>();
  using wavefront::prefetch_l2;
  const int64_t f = 3 * pc + d;
  const int64_t P = 3 * fl.ncp;
  prefetch_l2(fl.mask + f);
  prefetch_l2(fl.stat + f * NSTAT);
  prefetch_l2(fl.stat + f * NSTAT + NSTAT - 1);
#pragma unroll
  for (int v = 0; v < NV; ++v) prefetch_l2(fl.pre + f + v * P);
  if (ROE || (TP && d == 0)) {
#pragma unroll
    for (int e = 0; e < NEQ; ++e) prefetch_l2(fl.prim + e * fl.nc + c);
  }
#if SWEEP_TP
  if (d == 0) prefetch_l2(fl.eold + pc);
#else
  const int64_t nb = FORWARD ? c - stride_of(fl, d) : c + stride_of(fl, d);
#pragma unroll
  for (int e = 0; e < NEQ; ++e) prefetch_l2(fl.prim + e * fl.nc + nb);
#endif
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    if (e % wavefront::LANES != d) continue;
    prefetch_l2(fl.b + e * fl.ncp + pc);
    if (fl.extra) prefetch_l2(fl.extra + e * fl.ncp + pc);
  }
  prefetch_l2(fl.inv_f + pc);
  if constexpr (NEQ == T0 + 2) prefetch_l2(fl.inv_t + pc);
}

// one whole sweep of one block on persistent CTAs (sweep_wavefront.cuh)
template <int NS, int NEQ, bool VISCOUS, bool WILCOX, bool FORWARD>
__global__ void __launch_bounds__(wavefront::THREADS, 1)
    sweep_tiles(Fields fl, Phys ph, Species<NS> sp, wavefront::Schedule sc) {
  const int nj = sc.n[1], nk = sc.n[2];
  auto padded = [&](int i, int j, int k) {
    return fl.base + i * fl.stride[0] + j * fl.stride[1] + k * fl.stride[2];
  };
  auto physical = [&](int i, int j, int k) {
    return (static_cast<int64_t>(i) * nj + j) * nk + k;
  };
  // finish's operands loaded before the product hold 2 x 3 x ceil(NEQ / 3)
  // registers through it: a calorically perfect Roe form of more than 9
  // equations has none to spare, and loads them in finish row by row
  // (finish_rows), as the calorically perfect Rusanov forms do: their pairs
  // ran 1.5-5% slower with the loads before the product and 1-10% slower
  // with them all at finish's start, on the H100 (PERF.md, section 6)
  constexpr bool early = TP || (ROE && NEQ <= 9);
  FinishRows<NEQ> fr;
  auto prefetch = [&](int i, int j, int k, int d) {
    prefetch_stored<NS, NEQ, VISCOUS, FORWARD>(fl, padded(i, j, k),
                                               physical(i, j, k), d);
  };
  auto addends = [&](int i, int j, int k, int d, double (&x)[1][NEQ]) {
    const int64_t c = padded(i, j, k), pc = physical(i, j, k);
    if constexpr (early) load_finish<NS, NEQ, FORWARD>(fl, c, pc, d, fr);
    stored_product<NS, NEQ, VISCOUS, FORWARD>(fl, ph, sp, c, pc, d, x[0]);
  };
  auto finish = [&](int i, int j, int k, int d, const double (&acc)[NEQ]) {
    if constexpr (early)
      finish_loaded<NS, NEQ, FORWARD>(fl, padded(i, j, k), d, acc, fr);
    else
      finish_rows<NS, NEQ, FORWARD>(fl, padded(i, j, k), physical(i, j, k),
                                    d, acc);
  };
#if SWEEP_TP
  wavefront::walk<FORWARD, NEQ, 1, SWEEP_PROBE != 0, thermo::SPEC_LANES>(
      sc, prefetch, addends, finish,
      [&](int i, int j, int k, int r, unsigned group) {
        tp_state::invert_cell<NS, NEQ, SWEEP_PROBE != 0>(
            fl, ph, sp, padded(i, j, k), physical(i, j, k), r, group);
      });
#else
  wavefront::walk<FORWARD, NEQ, 1, SWEEP_PROBE != 0>(sc, prefetch, addends,
                                                     finish);
#endif
}

template <int NS, int NEQ, bool VISCOUS, bool WILCOX>
int launch_tiles(int forward, Fields fl, const Phys& ph,
                 const Species<NS>& sp, const wavefront::Schedule& sc,
                 cudaStream_t st, double* work) {
  if (!work) return static_cast<int>(cudaErrorInvalidValue);
  fl.pre = work;
#if SWEEP_TP
  tp_state::tp_state_space(fl, work + face_values<NS, NEQ, VISCOUS>() * 3 *
                                          fl.ncp);
#endif
  const int err =
      forward
          ? wavefront::launch_cells(prepass<NS, NEQ, VISCOUS, WILCOX, true>,
                                    3 * fl.ncp, wavefront::PREPASS_THREADS,
                                    st, fl, ph, sp, sc)
          : wavefront::launch_cells(prepass<NS, NEQ, VISCOUS, WILCOX, false>,
                                    3 * fl.ncp, wavefront::PREPASS_THREADS,
                                    st, fl, ph, sp, sc);
  if (err != 0) return err;
  // the thermally perfect forms' stage: thermo::SPEC_LANES threads a cell
  constexpr int lanes = TP ? thermo::SPEC_LANES : 0;
  if (forward)
    return wavefront::launch_lanes(
        lanes, sweep_tiles<NS, NEQ, VISCOUS, WILCOX, true>, sc, st, fl, ph,
        sp);
  return wavefront::launch_lanes(
      lanes, sweep_tiles<NS, NEQ, VISCOUS, WILCOX, false>, sc, st, fl, ph,
      sp);
}

// the four forms of one species count; species holds R_s, cv_s, cp_s,
// hf_s (NS each) and, for the thermally perfect forms, the species' mode
// counts (NS) and their temperatures (thermo::read_vib)
template <int NS>
int launch_form(int forward, int neq, int viscous, int wilcox,
                const Fields& fl, const Phys& ph, const double* species,
                const wavefront::Schedule& sc, cudaStream_t st,
                double* work) {
  constexpr int N = NS + 4;
  Species<NS> sp;
  for (int s = 0; s < NS; ++s) {
    sp.R[s] = species[s];
    sp.cv[s] = species[NS + s];
    sp.cp[s] = species[2 * NS + s];
    sp.hf[s] = species[3 * NS + s];
  }
#if SWEEP_TP
  if (!thermo::read_vib<NS>(species + 4 * NS, sp.vib))
    return static_cast<int>(cudaErrorInvalidValue);
#endif
  static_assert(sizeof(Fields) + sizeof(Phys) + sizeof(Species<NS>) +
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

// One whole sweep of one block: a cudaMemsetAsync of the schedule's state,
// the pre-pass and one tile-wavefront launch, all on `stream`.  ns is
// 1..BASE_NS, or SWEEP_NS in a build for that count, and neq is ns + 4 or
// ns + 6; viscous and wilcox select the form (see the head of
// this file; wilcox only with turbulence equations and viscous, and
// turbulence equations only with viscous); roe is 1 for the approximateRoe
// forms, which only the library built with SWEEP_ROE holds, tp 1 for the
// thermally perfect forms, which only the library built with SWEEP_TP
// holds.  R, cv, cp, hf, gamma and prandtl are the one species' (read
// when ns is 1 by the calorically perfect forms); species is a HOST
// array of the mixture's R_s, cv_s, cp_s and hf_s, ns each (read when ns
// > 1 or tp), then for tp the species' mode counts and their vibrational
// temperatures (launch_form).  stat
// (ni*nj*nk, 3, NSTAT) and mask (ni*nj*nk, 3) are in physical cell order.
// sched is a HOST array {ntiles, ni, nj, nk, ti, tj, tk, g, ctas} (ctas:
// the wavefront's persistent CTAs); tiles the device
// tile table (ntiles, 6) and state device scratch of 1 + ntiles ints
// (sweep_wavefront.cuh).  extra may be null (variant (a)); mu, mut, f1
// may be null when inviscid and inv_t without turbulence equations.  work
// is the device work space: per face of the sweep side face_values doubles
// (3 ncp faces), then for tp ncp old energies and NEQ x nc updated states
// (kernels/lusgs_sweep.py work_doubles); clocks null, or in the probe's
// build (SWEEP_PROBE) the device array of the step clocks (sweep_wavefront.cuh,
// namespace probe).  Returns
// cudaGetLastError() after the launches (0 when they were accepted), or
// cudaErrorInvalidValue for a form that does not exist or that another
// library holds.
extern "C" int lusgs_sweep_f64(
    int forward, int ns, int neq, int viscous, int wilcox, int roe, int tp,
    const double* prim,
    double* du, const double* mu, const double* mut, const double* f1,
    const double* b, const double* extra, const double* inv_f,
    const double* inv_t, const double* stat, const unsigned char* mask,
    long long nc, long long ncp, long long stride_i, long long stride_j,
    long long stride_k, const int* sched, const int* tiles, int* state,
    double R, double cv, double cp, double hf, double gamma, double prandtl,
    double prt, double scaling, double tmin_k, double tmin_w,
    double sigma_k1, double sigma_k2, const double* species, void* stream,
    double* work, unsigned long long* clocks) {
  if ((roe != 0) != ROE || (tp != 0) != TP || (clocks && !SWEEP_PROBE))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t base = sched[7] * (stride_i + stride_j + stride_k);
  Fields fl{prim, du,   mu,   mut, f1, b,   extra,
            inv_f, inv_t, stat, mask, nc, ncp, base,
            {stride_i, stride_j, stride_k}};
  Phys ph{R, cv, cp, hf, gamma, prandtl, prt, scaling,
          tmin_k, tmin_w, sigma_k1, sigma_k2};
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
