// Fused viscous residual for NVIDIA Hopper (sm_90a), float64.
//
// Replaces the TPU kernel aither_tpu/solver/pallas_residual.py::
// viscous_residual_march (pallas_call at pallas_residual.py:819), all four
// eddy-viscosity branches (pallas_residual.py:490-501, :617-618): one
// species, scalar solver, central viscous reconstruction, no wall law,
// calorically perfect gas, no pressure-gradient output.  Each branch is a
// compile-time instantiation viscous_tiles<MODEL>, so that none pays for
// another's live values:
//   SST (sst2003, sstdes; 7 equations): described below;
//   WILCOX (kOmegaWilcox2006; 7 equations): mut = rho k / max(omega,
//     Clim sqrt(2 S^:S^ / beta*)) with the traceless strain S^, f1 = 1,
//     f2 = 0; sigma* and sigma in the k and omega fluxes with the
//     UNLIMITED rho k / omega of the face state, and the unlimited form of
//     the cell state in the turbulence spectral radius;
//   WALE (largeEddySimulation; 5 equations): mut = (Cw len)^2 (Sd:Sd)^1.5 /
//     ((S:S)^2.5 + (Sd:Sd)^1.25 + EPS) from the face velocity gradient and
//     the face length `len` (a 27th face channel), f1 = 1, f2 = 0, the
//     turbulent conductivity mut cp / Prt in the energy flux.  The
//     reference's form has no rho and no 1/scaling (turbulence.cpp:967-990)
//     and is kept to the letter;
//   LAMINAR (navierStokes; 5 equations): no eddy viscosity; mut = f1 = f2
//     = 0.
// With 5 equations there are no k / omega gradients, fluxes or outputs and
// sr_turb = diag_turb = 0: 21 output channels instead of 29.
//
// What it computes (reference: procBlock.cpp:1233-1879 CalcViscFluxI/J/K
// with the face-CV gradient stencil of :1190-1231; the plain PyTorch twin is
// aither_tpu_torch/solver/viscous.py viscous_residual, expression for
// expression): for every face of the three directions, the face-centred
// control-volume Green-Gauss gradients of velocity, temperature, k and
// omega, the central face state (k, omega clamped to turb_min after the
// interpolation), the eddy viscosity and blending functions, tau.n, the
// heat flux and the k / omega diffusion fluxes times the face area; then per
// cell resid -= (fa_hi - fa_lo), the 1/6 cell averages of the face gradients
// and of mut, f1, f2, and the viscous spectral radii and diagonal terms
// (with the cell's lower-face mut and f1).  No face-sized field is written:
// only the 29 cell channels (resid 7, sr_flow, sr_turb, diag_flow,
// diag_turb, vel 9, tke 3, omega 3, mut, f1, f2), or the 21 of a
// 5-equation model (resid 5, no tke and omega).
//
// What bounds it on the card (kernels/viscous_march.py cost): at case B
// (2 blocks of 256x64x32 cells, 3.2M faces) the inputs are 0.79 GB, the
// face statics 0.67 GB of it, and the outputs 0.24 GB: 0.31 ms at 3.35
// TB/s.  The arithmetic, each face once, is 293-519 counted FP64
// operations a face and 170-287 a cell: about 2 GFLOP, 0.06 ms at 34
// TFLOP/s.  So bytes bound it on paper.  But the count takes a divide, a
// square root, a tanh or a pow as one operation, and each is a sequence of
// dependent FP64 instructions (for SST about 25 divides a face, 18 of them
// in the six CV gradients, two square roots, two tanh and one pow in the
// conductivity; three more pow for WALE): in practice the latency of that
// chain, and the FP64 warps in flight to hide it, decide the time.
//
// What held the first design back (one thread per cell, PRs 2 and 4;
// utils/viscous_probe.py on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md
// section 6): each of a face's two cells evaluated it, so that both got the
// same bits without communicating: twice the face arithmetic.  A thread
// held both faces of a direction (25 doubles each with 7 equations) beside
// its 29 accumulators: the SST and Wilcox instantiations took the
// 255-register limit and spilled about 450 bytes, so an SM held two
// 128-thread CTAs, 8 warps, by the registers.  Each face gathered its
// stencil and its 26 statics through the cache, one load each.  SST at case
// B took 1.66 ms.
//
// Design: march along i, each face once, through shared memory.
// - A CTA owns a tile of tj x tk (j, k) columns of one block and a segment
//   of `seg` consecutive i-planes (viscous_march.py viscous_tile, a function
//   of the block's dims only: 3 x 32 columns and segments of 22 planes at
//   case B, 2 waves of 132 CTAs; 64 x 1 columns at the one-cell-thick case
//   A).  blockIdx.x = segment * tiles + tile, so neighbouring tiles, which
//   share halo cells and edge faces, run together.  i is the march axis
//   because a padded i-plane of prim, T and mu is contiguous: each plane of
//   the window is one 2-D box per channel.
// - The window: a ring of 3 planes in shared memory, each the tile plus a
//   one-cell halo in j and k, (tj+2) x (tk+2) cells of the NEQ primitive
//   channels, T and mu: [slot][channel][j][k].  The faces of plane i read
//   planes i-1, i, i+1; once they are done (a barrier), plane i+2 is
//   copied by cp.async (8 bytes a thread) into the slot of plane i-1 while
//   the cells of plane i combine.
// - A step (plane i): each thread computes at most one face (THREADS >= the
//   faces of a 3 x 32 step, 323), in the order tj*tk upper i-faces,
//   (tj+1)*tk j-faces, tj*(tk+1) k-faces, with the one face routine
//   face_flux reading the window only.  A face's 21 most-read statics (the
//   six CV area vectors and the CV volume, read by all six gradients, and
//   the central coefficients) are staged in the thread's own slots of
//   shared memory by cp.async one step ahead, right after it computed the
//   same face one plane lower; the others (normal, area, wall distance,
//   length) are prefetched to L2 then and read from device memory.  Each
//   face's record (fa[1..NEQ-1], the velocity gradient, k and omega
//   gradients, mut, f1, f2: what the cell combination reads, 24 doubles for
//   SST, 13 for laminar; fa[0] and the constant mut / f1 / f2 of a branch
//   are not stored) goes to shared memory, channel-major.  After a barrier,
//   four threads per cell combine its six records (resid and the flow
//   radius, the turbulence radius, the velocity-gradient average, the k /
//   omega averages and mut, f1, f2), each output channel written once,
//   coalesced along k.
// - The upper i-face records of a step are the next step's lower ones: two
//   buffers swap, nothing is recomputed.  A segment computes its first
//   lower i-face plane itself, so each segment's first i-face plane is
//   computed twice, once by each segment beside it.  The j / k faces on a
//   tile's edge are computed by both tiles beside them, with the same
//   instructions on the same operands: bitwise the same flux, so the
//   residual stays conservative with no atomics.
// - Occupancy: shared memory per CTA (smem_doubles: window, records, staged
//   statics; 167 KiB for SST at 3 x 32) allows one CTA per SM.  Its 12
//   warps may use 168 registers each (a sub-partition holds three); 14 or
//   16 warps cap them at 128, where every instantiation spilled.  The
//   statics are read where used (volatile), not held across the six
//   gradients, which keeps the four instantiations at 168 registers or
//   fewer without a spill.  viscous_march_info reports the
//   bytes, the CTAs per SM and the registers of each instantiation.
// - What holds it now (PERF.md section 6; SM clocks of the measurement
//   build): SST at case B takes 0.94 ms, 3.1 times its bound.  A step is
//   one face's serial FP64 chain, about 14,700 cycles of which the six
//   gradients take 6,900, on 12 warps an SM, then about 7,400 cycles of
//   combine, whose own arithmetic is a third of that; the FP64 units wait
//   on latency, not on bandwidth (1.1 TB/s of the cost() bytes).
// - Tensor cores do not apply: every face has its own stencil coefficients
//   (CV area vectors and volume), so no operand matrix is shared across
//   faces, and a gradient is a 6-term dot product, not a matrix product;
//   wgmma has nothing to multiply.
//
// Its bits against the first design's and the plain version's: face_flux
// is the first design's routine, operand for operand, reading the same
// values from shared memory that it read from device memory, with __dmul_rn
// area products that are never fused with the cell's flux difference;
// every cell combines its six faces in the order i, j, k, each output
// channel with the expressions of the first design, lower before upper.
// Each face is one evaluation, so the two cells of a face see the same bits
// and the residual is conservative.  Where nvcc contracts a multiply and an
// add into an FMA is its own choice per build, so the two designs agree to
// an ulp, not bit for bit (largest difference 2.6e-26 of a 3.9e-9 residual
// at case B SST, utils/viscous_probe.py); against the plain PyTorch version
// FMA contraction and the card's math library differ (chip_smoke.py holds
// them to rtol 1e-9 / atol 1e-13 x scale, at the first design's worst
// ratios).  tests/test_torch_viscous_tiles.py emulates this schedule on the
// CPU and holds it to the plain version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int IT = 5;          // first turbulence equation (7 equations)
constexpr int THREADS = 384;   // 12 warps: one face each, a 3 x 32 step
constexpr int MAX_COLUMNS = 96;  // tj * tk; 4 of them fit THREADS
constexpr int SLOTS = 3;       // window planes i-1, i, i+1 (then i+2)

// the eddy-viscosity branch (kernels/viscous_march.py MODELS)
enum Model { SST = 0, WILCOX = 1, WALE = 2, LAMINAR = 3 };
__host__ __device__ constexpr int neq_of(int model) {
  return model <= WILCOX ? 7 : 5;
}
constexpr double EPS = 1.0e-30;

// face static channels (solver/viscous.py FACE_CHANNELS)
constexpr int ADU = 0, ADL = 3, A1U = 6, A1L = 9, A2U = 12, A2L = 15,
              VCV = 18, NRM = 19, MAG = 22, C0 = 23, C1 = 24, WDF = 25,
              LEN = 26;  // LEN only in the WALE statics
// the channels a face stages in shared memory, one step ahead: the CV area
// vectors and volume (ADU .. VCV, read by all six gradients) and the
// central coefficients, at staged indices 0-18, SC0, SC1
constexpr int STAGED = 21, SC0 = 19, SC1 = 20;
__host__ __device__ constexpr int staged_channel(int c) {
  return c < SC0 ? c : (c == SC0 ? C0 : C1);
}

// order of the host parameter array (kernels/viscous_march.py PARAMS)
struct Params {
  double scaling, R, cp, gamma, cond_c1, cond_s, t_ref, k_nondim;
  double tmin_k, tmin_w, visc_coeff;
  double beta_star, sigma_k1, sigma_k2, sigma_w1, sigma_w2, a1, prt;
  double sigma_star, sigma, clim;  // Wilcox 2006
  double cw;                       // WALE
};
constexpr int NPARAMS = 22;

struct Fields {
  const double* __restrict__ prim;   // (NEQ, NI, NJ, NK)
  const double* __restrict__ t;      // (NI, NJ, NK)
  const double* __restrict__ mu;     // (NI, NJ, NK)
  const double* __restrict__ face[3];  // (26, F_d); WALE (27, F_d)
  const double* __restrict__ cell;   // (4, ni, nj, nk)
  double* __restrict__ out;          // (29 or 21, ni, nj, nk)
  int64_t nc;         // NI*NJ*NK: equation stride of the padded fields
  int64_t ncell;      // ni*nj*nk: channel stride of cell and out
  int64_t nf[3];      // faces per direction: channel stride of face[d]
  int NJ, NK;         // padded extents (j and k strides of a plane: NK, 1)
  int ni, nj, nk, g;
};

// the launch's tiles: tj x tk columns, seg planes; ntk tiles along k,
// ntiles per block
struct Plan {
  int tj, tk, seg, ntk, ntiles;
};

template <int NEQ>
struct Face {
  double fa[NEQ];    // flux times area (fa[0] is 0: no species diffusion)
  double vg[9];      // vg[3A+B] = d v_B / d x_A
  double kg[NEQ == 7 ? 3 : 1], wg[NEQ == 7 ? 3 : 1];  // 7 equations only
  double mut, f1, f2;
};

// a face record's channels in shared memory: fa[1..NEQ-1], vg, kg and wg
// (7 equations), then the eddy viscosity and blending values a branch does
// not fix (SST: mut, f1, f2; Wilcox and WALE: mut; laminar: none)
template <int MODEL>
struct Rec {
  static constexpr int NEQ = neq_of(MODEL);
  static constexpr int VG = NEQ - 1;
  static constexpr int KG = VG + 9, WG = KG + 3;
  static constexpr int MUT = VG + 9 + (NEQ == 7 ? 6 : 0);
  static constexpr int N =
      MODEL == SST ? MUT + 3 : (MODEL == LAMINAR ? MUT : MUT + 1);
};

// dynamic shared memory of one CTA: the window ring, the records and the
// staged statics of a step's faces (kernels/viscous_march.py smem_bytes)
__host__ __device__ constexpr int64_t smem_doubles(int model, int tj,
                                                   int tk) {
  return int64_t{SLOTS} * (neq_of(model) + 2) * (tj + 2) * (tk + 2) +
         int64_t{model == SST      ? 24
                 : model == WILCOX ? 22
                 : model == WALE   ? 14
                                   : 13} *
             (2 * tj * tk + (tj + 1) * tk + tj * (tk + 1)) +
         int64_t{STAGED} * (3 * tj * tk + tj + tk);
}
constexpr int64_t MAX_SMEM = 232448;  // an H100 CTA's opt-in maximum

#ifdef VISCOUS_PHASE_CLOCKS
// A measurement build (utils/viscous_probe.py --phases): one thread of each
// of the first CLOCK_CTAS CTAs records clock64() at the marks CLOCK(on, k)
// (on: the recording thread), after `x` is computed with CLOCK_AFTER:
//   0 start, 1 window and statics of the first step arrived, 2 + 2p / 3 + 2p
//   step p's faces begin / end (p < 32), 66 thread 0's last combine done;
//   67-73 thread 0's last face: begin, face state, gradients, eddy
//   viscosity, tau, energy flux, end; 74 / 75 and 76 / 77 the combine of
//   the first cell, resid and flow radius / turbulence radius, begin / end.
constexpr int CLOCK_CTAS = 8192, CLOCKS = 80;
__device__ long long phase_clocks[CLOCK_CTAS * CLOCKS];
__device__ __forceinline__ void clock_mark(bool on, int k) {
  if (on && blockIdx.x < CLOCK_CTAS && k < CLOCKS) {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
    phase_clocks[blockIdx.x * CLOCKS + k] = t;
  }
}
#define CLOCK(on, k) clock_mark(on, k)
#define CLOCK_AFTER(on, k, x)                      \
  do {                                             \
    asm volatile("" ::"d"(x) : "memory");          \
    clock_mark(on, k);                             \
  } while (0)
#else
#define CLOCK(on, k)
#define CLOCK_AFTER(on, k, x)
#endif

// Green-Gauss gradient of one field over the face-centred CV of the face
// whose lower cell is `lo` (viscous.py face_cv_gradients), read from the
// window: sd steps to the upper cell, u1 / l1 and u2 / l2 to the upper and
// lower neighbours along the two transverse directions (in ijk order; a
// step along i crosses ring slots, so the two are not opposite)
__device__ __forceinline__ void cv_gradient(const double* f,
                                            const double* Sc, int ncs,
                                            int lo, int sd, int u1, int l1,
                                            int u2, int l2, double out[3]) {
  const double qlo = f[lo], qhi = f[lo + sd];
  const double v1u = 0.25 * (qlo + qhi + f[lo + sd + u1] + f[lo + u1]);
  const double v1l = 0.25 * (qlo + qhi + f[lo + sd + l1] + f[lo + l1]);
  const double v2u = 0.25 * (qlo + qhi + f[lo + sd + u2] + f[lo + u2]);
  const double v2l = 0.25 * (qlo + qhi + f[lo + sd + l2] + f[lo + l2]);
  // read where used, not held in registers across the six gradients
  const volatile double* V = Sc;
  const double vcv = V[VCV * ncs];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    out[a] = (qhi * V[(ADU + a) * ncs] - qlo * V[(ADL + a) * ncs] +
              v1u * V[(A1U + a) * ncs] - v1l * V[(A1L + a) * ncs] +
              v2u * V[(A2U + a) * ncs] - v2l * V[(A2L + a) * ncs]) /
             vcv;
}

__device__ __forceinline__ double clamp_min(double x, double lo) {
  return x < lo ? lo : x;  // torch.clamp(min=): NaN propagates
}

// One face: `w` the window (channel stride wch), `lo` the lower cell's
// window index, the stencil steps as in cv_gradient; Sc the face's staged
// statics in shared memory (channel stride ncs), S its statics in device
// memory (channel stride nf).  viscous.py viscous_residual's face section.
template <int MODEL>
__device__ __forceinline__ void face_flux(const Params& P, const double* w,
                                          int wch, int lo, int sd, int u1,
                                          int l1, int u2, int l2,
                                          const double* Sc, int ncs,
                                          const double* __restrict__ S,
                                          int64_t nf,
                                          Face<neq_of(MODEL)>& o) {
  constexpr int NEQ = neq_of(MODEL);
  const double* tw = w + NEQ * wch;
  const double* muw = w + (NEQ + 1) * wch;

  CLOCK(threadIdx.x == 0, 67);
  // central face state, turbulence clamped after the interpolation
  const double c0 = Sc[SC0 * ncs], c1 = Sc[SC1 * ncs];
  double qf[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e)
    qf[e] = c0 * w[e * wch + lo + sd] + c1 * w[e * wch + lo];
  if constexpr (NEQ == 7) {
    qf[IT] = clamp_min(qf[IT], P.tmin_k);
    qf[IT + 1] = clamp_min(qf[IT + 1], P.tmin_w);
  }
  const double muf = c0 * muw[lo + sd] + c1 * muw[lo];
  CLOCK_AFTER(threadIdx.x == 0, 68, muf + qf[NEQ - 1]);

  // face-CV gradients
  double g[3], tg[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    cv_gradient(w + (1 + b) * wch, Sc, ncs, lo, sd, u1, l1, u2, l2, g);
#pragma unroll
    for (int a = 0; a < 3; ++a) o.vg[3 * a + b] = g[a];
  }
  cv_gradient(tw, Sc, ncs, lo, sd, u1, l1, u2, l2, tg);
  if constexpr (NEQ == 7) {
    cv_gradient(w + IT * wch, Sc, ncs, lo, sd, u1, l1, u2, l2, o.kg);
    cv_gradient(w + (IT + 1) * wch, Sc, ncs, lo, sd, u1, l1, u2, l2, o.wg);
  }

  const double rho = qf[0];
  const double trace = o.vg[0] + o.vg[4] + o.vg[8];
  CLOCK_AFTER(threadIdx.x == 0, 69, trace + tg[0]);
  if constexpr (MODEL == SST) {
    // SST 2003 eddy viscosity and blending (viscous.eddy_visc_and_blending)
    const double tke = qf[IT], omega = qf[IT + 1];
    const double wdf = S[WDF * nf];
    const double wde = wdf + EPS;
    const double alpha1 =
        P.scaling * sqrt(tke) / (P.beta_star * omega * wde);
    const double alpha2 =
        P.scaling * P.scaling * 500.0 * muf / (wde * wde * rho * omega);
    const double kdotw =
        o.kg[0] * o.wg[0] + o.kg[1] * o.wg[1] + o.kg[2] * o.wg[2];
    const double cdkw =
        clamp_min(2.0 * rho * P.sigma_w2 / omega * kdotw, 1.0e-10);
    const double alpha3 =
        4.0 * rho * P.sigma_w2 * tke / (cdkw * (wde * wde));
    const double m1 = fmin(fmax(alpha1, alpha2), alpha3);
    const double m12 = m1 * m1;
    o.f1 = tanh(m12 * m12);
    const double m2 = fmax(2.0 * alpha1, alpha2);
    o.f2 = tanh(m2 * m2);
    double dd = 0.0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const double sr = 0.5 * (o.vg[3 * a + b] + o.vg[3 * b + a]);
        dd += sr * sr;
      }
    const double mean_sr = sqrt(2.0 * dd);
    o.mut =
        rho * P.a1 * tke / fmax(P.a1 * omega, P.scaling * mean_sr * o.f2);
  } else if constexpr (MODEL == WILCOX) {
    // Wilcox 2006: the stress limiter on the traceless strain
    double dd = 0.0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const double sh = 0.5 * (o.vg[3 * a + b] + o.vg[3 * b + a]) -
                          (a == b ? trace / 3.0 : 0.0);
        dd += sh * sh;
      }
    const double omega_tilda = fmax(
        qf[IT + 1], P.scaling * P.clim * sqrt(2.0 * dd / P.beta_star));
    o.mut = rho * qf[IT] / omega_tilda;
    o.f1 = 1.0;
    o.f2 = 0.0;
  } else if constexpr (MODEL == WALE) {
    // WALE: the traceless symmetric square of the velocity gradient.  The
    // reference's form has no rho and no 1/scaling; kept to the letter.
    double g2[9];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        g2[3 * a + b] = o.vg[3 * a] * o.vg[b] + o.vg[3 * a + 1] * o.vg[3 + b] +
                        o.vg[3 * a + 2] * o.vg[6 + b];
    const double tr2 = g2[0] + g2[4] + g2[8];
    double sdd = 0.0, srr = 0.0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const double sdv = 0.5 * (g2[3 * a + b] + g2[3 * b + a]) -
                           (a == b ? tr2 / 3.0 : 0.0);
        sdd += sdv * sdv;
        const double sr = 0.5 * (o.vg[3 * a + b] + o.vg[3 * b + a]);
        srr += sr * sr;
      }
    // pow(0, 1.5) = pow(0, 2.5) = pow(0, 1.25) = 0: at a uniform state only
    // EPS keeps the quotient finite (0 / EPS = 0)
    const double num = pow(sdd, 1.5);
    const double den = pow(srr, 2.5) + pow(sdd, 1.25) + EPS;
    const double cl = P.cw * S[LEN * nf];
    o.mut = cl * cl * num / den;
    o.f1 = 1.0;
    o.f2 = 0.0;
  } else {
    o.mut = 0.0;
    o.f1 = 0.0;
    o.f2 = 0.0;
  }

  CLOCK_AFTER(threadIdx.x == 0, 70, o.mut + o.f1);
  // tau.n (viscous.tau_normal), heat flux, k / omega diffusion
  const double n0 = S[NRM * nf], n1 = S[(NRM + 1) * nf],
               n2 = S[(NRM + 2) * nf];
  const double mu_s = P.scaling * muf;
  const double mut_s = P.scaling * o.mut;
  const double mu_eff = mu_s + mut_s;
  const double lam = -2.0 / 3.0 * mu_eff;
  double tau[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    tau[a] = lam * trace * (a == 0 ? n0 : a == 1 ? n1 : n2) +
             mu_eff * ((o.vg[3 * a] + o.vg[a]) * n0 +
                       (o.vg[3 * a + 1] + o.vg[3 + a]) * n1 +
                       (o.vg[3 * a + 2] + o.vg[6 + a]) * n2);
  CLOCK_AFTER(threadIdx.x == 0, 71, tau[0] + tau[2]);
  const double tf = qf[4] / (P.R * qf[0]);
  const double td = tf * P.t_ref;
  const double k_eff =
      P.scaling * (P.cond_c1 * pow(td, 1.5) / (td + P.cond_s) / P.k_nondim);
  const double kt = MODEL == LAMINAR ? 0.0 : mut_s * P.cp / P.prt;
  const double tgn = tg[0] * n0 + tg[1] * n1 + tg[2] * n2;
  const double e_flux =
      tau[0] * qf[1] + tau[1] * qf[2] + tau[2] * qf[3] + (k_eff + kt) * tgn;
  CLOCK_AFTER(threadIdx.x == 0, 72, e_flux);
  const double mag = S[MAG * nf];
  o.fa[0] = 0.0;
  o.fa[1] = __dmul_rn(tau[0], mag);
  o.fa[2] = __dmul_rn(tau[1], mag);
  o.fa[3] = __dmul_rn(tau[2], mag);
  o.fa[4] = __dmul_rn(e_flux, mag);
  if constexpr (NEQ == 7) {
    double sk, sw, mutt;
    if constexpr (MODEL == WILCOX) {
      // unlimited eddy viscosity for the turbulence diffusion
      sk = P.sigma_star;
      sw = P.sigma;
      mutt = P.scaling * rho * qf[IT] / qf[IT + 1];
    } else {
      sk = o.f1 * P.sigma_k1 + (1.0 - o.f1) * P.sigma_k2;
      sw = o.f1 * P.sigma_w1 + (1.0 - o.f1) * P.sigma_w2;
      mutt = mut_s;
    }
    const double kgn = o.kg[0] * n0 + o.kg[1] * n1 + o.kg[2] * n2;
    const double wgn = o.wg[0] * n0 + o.wg[1] * n1 + o.wg[2] * n2;
    o.fa[5] = __dmul_rn((mu_s + sk * mutt) * kgn, mag);
    o.fa[6] = __dmul_rn((mu_s + sw * mutt) * wgn, mag);
  }
  CLOCK_AFTER(threadIdx.x == 0, 73, o.fa[NEQ - 1]);
}

// the record of face `o` into record slot `r` of `rec` (nr slots a channel)
template <int MODEL>
__device__ __forceinline__ void store_record(const Face<neq_of(MODEL)>& o,
                                             double* rec, int nr, int r) {
  using R = Rec<MODEL>;
#pragma unroll
  for (int e = 1; e < R::NEQ; ++e) rec[(e - 1) * nr + r] = o.fa[e];
#pragma unroll
  for (int e = 0; e < 9; ++e) rec[(R::VG + e) * nr + r] = o.vg[e];
  if constexpr (R::NEQ == 7) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      rec[(R::KG + e) * nr + r] = o.kg[e];
      rec[(R::WG + e) * nr + r] = o.wg[e];
    }
  }
  if constexpr (MODEL != LAMINAR) rec[R::MUT * nr + r] = o.mut;
  if constexpr (MODEL == SST) {
    rec[(R::MUT + 1) * nr + r] = o.f1;
    rec[(R::MUT + 2) * nr + r] = o.f2;
  }
}

// a record's mut, f1 and f2: stored, or the branch's constants (the first
// design's face_flux set the same constants)
template <int MODEL>
__device__ __forceinline__ double rec_mut(const double* rec, int nr, int r) {
  if constexpr (MODEL == LAMINAR) return 0.0;
  else return rec[Rec<MODEL>::MUT * nr + r];
}
template <int MODEL>
__device__ __forceinline__ double rec_f1(const double* rec, int nr, int r) {
  if constexpr (MODEL == SST) return rec[(Rec<MODEL>::MUT + 1) * nr + r];
  else return MODEL == LAMINAR ? 0.0 : 1.0;
}
template <int MODEL>
__device__ __forceinline__ double rec_f2(const double* rec, int nr, int r) {
  if constexpr (MODEL == SST) return rec[(Rec<MODEL>::MUT + 2) * nr + r];
  else return 0.0;
}
// fa[e] of a record (fa[0] is 0)
template <int MODEL>
__device__ __forceinline__ double rec_fa(const double* rec, int nr, int r,
                                         int e) {
  return e == 0 ? 0.0 : rec[(e - 1) * nr + r];
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const double* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

template <int MODEL>
__global__ void __launch_bounds__(THREADS, 1)
    viscous_tiles(Fields F, Params P, Plan L) {
  constexpr int NEQ = neq_of(MODEL);
  constexpr int NCH = NEQ + 2;  // window channels: prim, T, mu
  // output channels
  constexpr int O_RESID = 0, O_SRF = NEQ, O_SRT = NEQ + 1, O_DGF = NEQ + 2,
                O_DGT = NEQ + 3, O_VEL = NEQ + 4, O_TKE = O_VEL + 9,
                O_OMG = O_TKE + 3, O_MUT = O_VEL + 9 + (NEQ == 7 ? 6 : 0),
                O_F1 = O_MUT + 1, O_F2 = O_MUT + 2;
  extern __shared__ double smem[];

  // this CTA's tile (origin j0, k0, extent ej x ek) and segment (planes i0
  // .. i0 + np - 1)
  const int tile = static_cast<int>(blockIdx.x % L.ntiles);
  const int i0 = static_cast<int>(blockIdx.x / L.ntiles) * L.seg;
  const int j0 = (tile / L.ntk) * L.tj, k0 = (tile % L.ntk) * L.tk;
  const int ej = min(L.tj, F.nj - j0), ek = min(L.tk, F.nk - k0);
  const int np = min(L.seg, F.ni - i0);
  // window layout [slot][channel][j][k], (ej+2) x (ek+2) a channel
  const int wk = ek + 2, wch = (ej + 2) * wk, wslot = NCH * wch;
  // record slots: two i-face buffers, the j-faces, the k-faces
  const int ncol = ej * ek, njf = (ej + 1) * ek, nkf = ej * (ek + 1);
  const int nr = 2 * ncol + njf + nkf, jrec = 2 * ncol, krec = jrec + njf;
  const int nfaces = ncol + njf + nkf;
  double* win = smem;
  double* rec = smem + SLOTS * wslot;
  double* stat = rec + static_cast<int64_t>(Rec<MODEL>::N) * nr;
  const int tid = static_cast<int>(threadIdx.x);
  CLOCK(tid == 0, 0);

  // copy physical plane q (-1 .. ni) of the tile's box into ring slot sl
  auto load_plane = [&](int q, int sl) {
    const int64_t base = static_cast<int64_t>(q + F.g) * F.NJ * F.NK +
                         static_cast<int64_t>(j0 - 1 + F.g) * F.NK +
                         (k0 - 1 + F.g);
    double* dst = win + sl * wslot;
    for (int n = tid; n < NCH * wch; n += THREADS) {
      const int ch = n / wch, r = n - ch * wch;
      const int jj = r / wk, kk = r - jj * wk;
      const double* src = ch < NEQ ? F.prim + ch * F.nc
                                   : (ch == NEQ ? F.t : F.mu);
      cp_async8(dst + n, src + base + static_cast<int64_t>(jj) * F.NK + kk);
    }
  };
  // face f of plane i (f < ncol: the i-face above column f; then the
  // j-faces, then the k-faces): its window stencil (lower cell and steps)
  // for ring slot s, up / dn the steps to planes i+1 / i-1, and its
  // statics with their channel stride
  struct At {
    int lo, sd, u1, l1, u2, l2;
    const double* S;
    int64_t nf;
  };
  auto face_at = [&](int f, int i, int s, int up, int dn) {
    At a;
    if (f < ncol) {
      const int j = f / ek, k = f - j * ek;
      a = {s * wslot + (j + 1) * wk + (k + 1), up, wk, -wk, 1, -1,
           F.face[0] + (static_cast<int64_t>(i + 1) * F.nj + j0 + j) *
                           F.nk + k0 + k,
           F.nf[0]};
    } else if (f < ncol + njf) {
      // between rows jj-1 and jj of the tile
      const int r = f - ncol, jj = r / ek, k = r - jj * ek;
      a = {s * wslot + jj * wk + (k + 1), wk, up, dn, 1, -1,
           F.face[1] + (static_cast<int64_t>(i) * (F.nj + 1) + j0 + jj) *
                           F.nk + k0 + k,
           F.nf[1]};
    } else {
      // between columns kk-1 and kk of the tile
      const int r = f - ncol - njf, j = r / (ek + 1), kk = r - j * (ek + 1);
      a = {s * wslot + (j + 1) * wk + kk, 1, up, dn, wk, -wk,
           F.face[2] + (static_cast<int64_t>(i) * F.nj + j0 + j) *
                           (F.nk + 1) + k0 + kk,
           F.nf[2]};
    }
    return a;
  };
  // stage face f's statics S (channel stride nf) in its own slots, and
  // prefetch the rest to L2
  auto stage = [&](int f, const double* S, int64_t nf) {
#pragma unroll
    for (int c = 0; c < STAGED; ++c)
      cp_async8(stat + c * nfaces + f, S + staged_channel(c) * nf);
    prefetch_l2(S + NRM * nf);
    prefetch_l2(S + (NRM + 1) * nf);
    prefetch_l2(S + (NRM + 2) * nf);
    prefetch_l2(S + MAG * nf);
    if constexpr (MODEL == SST) prefetch_l2(S + WDF * nf);
    if constexpr (MODEL == WALE) prefetch_l2(S + LEN * nf);
  };
  auto compute = [&](int f, const At& a, int r) {
    Face<NEQ> o;
    face_flux<MODEL>(P, win, wch, a.lo, a.sd, a.u1, a.l1, a.u2, a.l2,
                     stat + f, nfaces, a.S, a.nf, o);
    store_record<MODEL>(o, rec, nr, r);
  };

  // the ring: plane i0-1+q in slot q % 3
  load_plane(i0 - 1, 0);
  load_plane(i0, 1);
  load_plane(i0 + 1, 2);
  // warm-up: the segment's first lower i-faces (planes i0-1 | i0, slots
  // 0 | 1), whose staged statics the first step's i-faces take over; the
  // other faces stage the first step's statics
  for (int f = tid; f < nfaces; f += THREADS) {
    const At a = f < ncol ? face_at(f, i0 - 1, 0, wslot, 0)
                          : face_at(f, i0, 1, wslot, -wslot);
    stage(f, a.S, a.nf);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  CLOCK(tid == 0, 1);
  int ilo = 0, ihi = ncol;
  for (int f = tid; f < ncol; f += THREADS) {
    const At a = face_at(f, i0 - 1, 0, wslot, 0);
    compute(f, a, ilo + f);
    stage(f, a.S + F.nj * F.nk, a.nf);  // the first step's i-face f
  }
  cp_async_commit();

  int s = 1;  // ring slot of plane i
#pragma unroll 1
  for (int p = 0; p < np; ++p) {
    const int i = i0 + p;
    const int s_up = s == 2 ? 0 : s + 1, s_dn = s == 0 ? 2 : s - 1;
    const int up = (s_up - s) * wslot, dn = (s_dn - s) * wslot;
    // plane i+1 and this step's staged statics have arrived
    cp_async_wait_all();
    __syncthreads();
    CLOCK(tid == 0, 2 + 2 * p);
    // the combine's cell statics, to L2
    if (tid < ncol) {
      const int j = tid / ek, k = tid - j * ek;
      const double* c =
          F.cell + (static_cast<int64_t>(i) * F.nj + j0 + j) * F.nk + k0 + k;
#pragma unroll
      for (int n = 0; n < 4; ++n) prefetch_l2(c + n * F.ncell);
    }

    // faces of plane i: upper i-faces, j-faces, k-faces; each thread then
    // stages its faces of plane i+1
#pragma unroll 1
    for (int f = tid; f < nfaces; f += THREADS) {
      const At a = face_at(f, i, s, up, dn);
      compute(f, a, f < ncol ? ihi + f : (f < ncol + njf ? jrec + f - ncol
                                                         : krec + f - ncol -
                                                               njf));
      if (p + 1 < np) {
        // the same face one plane up
        const int64_t up_plane =
            f < ncol         ? static_cast<int64_t>(F.nj) * F.nk
            : f < ncol + njf ? static_cast<int64_t>(F.nj + 1) * F.nk
                             : static_cast<int64_t>(F.nj) * (F.nk + 1);
        stage(f, a.S + up_plane, a.nf);
      }
    }
    cp_async_commit();
    __syncthreads();
    CLOCK(tid == 0, 3 + 2 * p);
    // plane i-1 is read no more: plane i+2 takes its slot, copied while the
    // cells combine
    if (p + 1 < np) load_plane(i + 2, s_dn);
    cp_async_commit();

    // combine: four threads a cell, each its own output channels
#pragma unroll 1
    for (int n = tid; n < 4 * ncol; n += THREADS) {
      const int part = n / ncol, c = n - part * ncol;
      const int j = c / ek, k = c - j * ek;
      // the cell's lower and upper face records along i, j, k
      const int lo[3] = {ilo + c, jrec + j * ek + k,
                         krec + j * (ek + 1) + k};
      const int hi[3] = {ihi + c, jrec + (j + 1) * ek + k,
                         krec + j * (ek + 1) + k + 1};
      const int64_t t =
          (static_cast<int64_t>(i) * F.nj + j0 + j) * F.nk + k0 + k;
      double* __restrict__ out = F.out + t;
      const int64_t n_out = F.ncell;
      const double sixth = 1.0 / 6.0;
      const int wc = s * wslot + (j + 1) * wk + (k + 1);  // the cell
      if (part == 0) {
        CLOCK(n == 0, 74);
        // resid, the flow spectral radius and diagonal term
        const double r_c = win[wc];
        const double mu_c = win[wc + (NEQ + 1) * wch];
        const double vol_c = F.cell[t];
        const double max_term = fmax(4.0 / (3.0 * r_c), P.gamma / r_c);
        const double prand = 4.0 * P.gamma / (9.0 * P.gamma - 5.0);
        double resid[NEQ];
#pragma unroll
        for (int e = 0; e < NEQ; ++e) resid[e] = 0.0;
        double sr_f = 0.0, dg_f = 0.0;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
#pragma unroll
          for (int e = 0; e < NEQ; ++e)
            resid[e] = resid[e] - (rec_fa<MODEL>(rec, nr, hi[d], e) -
                                   rec_fa<MODEL>(rec, nr, lo[d], e));
          // viscous spectral radius: mut at the cell's lower face
          const double fmag = F.cell[(1 + d) * F.ncell + t];
          const double visc_term =
              P.scaling *
              (mu_c / prand + (MODEL == LAMINAR
                                   ? 0.0
                                   : rec_mut<MODEL>(rec, nr, lo[d]) / P.prt));
          const double vsr = max_term * visc_term * fmag * fmag / vol_c;
          sr_f = sr_f + P.visc_coeff * vsr;
          dg_f = dg_f + 2.0 * vsr;
        }
#pragma unroll
        for (int e = 0; e < NEQ; ++e) out[(O_RESID + e) * n_out] = resid[e];
        out[O_SRF * n_out] = sr_f;
        out[O_DGF * n_out] = dg_f;
        CLOCK_AFTER(n == 0, 75, dg_f);
      } else if (part == 1) {
        // the turbulence spectral radius and diagonal term (0 with 5
        // equations)
        CLOCK(c == 0, 76);
        double sr_t = 0.0, dg_t = 0.0;
        if constexpr (NEQ == 7) {
          const double r_c = win[wc];
          const double mu_c = win[wc + (NEQ + 1) * wch];
          const double vol_c = F.cell[t];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const double fmag = F.cell[(1 + d) * F.ncell + t];
            double tvsr;
            if constexpr (MODEL == WILCOX) {
              // the unlimited rho k / omega of the cell state
              const double mut_nolim =
                  r_c * win[wc + IT * wch] / win[wc + (IT + 1) * wch];
              tvsr = P.scaling * (fmag * fmag / vol_c) / r_c *
                     (mu_c + P.sigma_star * mut_nolim);
            } else {
              // mut and f1 at the cell's lower face
              const double lo_mut = rec_mut<MODEL>(rec, nr, lo[d]);
              const double lo_f1 = rec_f1<MODEL>(rec, nr, lo[d]);
              const double sk =
                  lo_f1 * P.sigma_k1 + (1.0 - lo_f1) * P.sigma_k2;
              tvsr = P.scaling * (fmag * fmag / vol_c) / r_c *
                     (mu_c + sk * lo_mut);
            }
            sr_t = sr_t + P.visc_coeff * tvsr;
            dg_t = dg_t + 2.0 * tvsr;
          }
        }
        out[O_SRT * n_out] = sr_t;
        out[O_DGT * n_out] = dg_t;
        CLOCK_AFTER(c == 0, 77, dg_t);
      } else if (part == 2) {
        // the velocity-gradient average
        constexpr int VG = Rec<MODEL>::VG;
        double vel[9];
#pragma unroll
        for (int e = 0; e < 9; ++e) vel[e] = 0.0;
#pragma unroll
        for (int d = 0; d < 3; ++d)
#pragma unroll
          for (int e = 0; e < 9; ++e)
            vel[e] = vel[e] + sixth * (rec[(VG + e) * nr + lo[d]] +
                                       rec[(VG + e) * nr + hi[d]]);
#pragma unroll
        for (int e = 0; e < 9; ++e) out[(O_VEL + e) * n_out] = vel[e];
      } else {
        // the k and omega gradient averages, mut, f1, f2
        double tke[3], omg[3];
#pragma unroll
        for (int e = 0; e < 3; ++e) tke[e] = omg[e] = 0.0;
        double mut = 0.0, f1 = 0.0, f2 = 0.0;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          if constexpr (NEQ == 7) {
            constexpr int KG = Rec<MODEL>::KG, WG = Rec<MODEL>::WG;
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              tke[e] = tke[e] + sixth * (rec[(KG + e) * nr + lo[d]] +
                                         rec[(KG + e) * nr + hi[d]]);
              omg[e] = omg[e] + sixth * (rec[(WG + e) * nr + lo[d]] +
                                         rec[(WG + e) * nr + hi[d]]);
            }
          }
          mut = mut + sixth * (rec_mut<MODEL>(rec, nr, lo[d]) +
                               rec_mut<MODEL>(rec, nr, hi[d]));
          f1 = f1 + sixth * (rec_f1<MODEL>(rec, nr, lo[d]) +
                             rec_f1<MODEL>(rec, nr, hi[d]));
          f2 = f2 + sixth * (rec_f2<MODEL>(rec, nr, lo[d]) +
                             rec_f2<MODEL>(rec, nr, hi[d]));
        }
        if constexpr (NEQ == 7) {
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            out[(O_TKE + e) * n_out] = tke[e];
            out[(O_OMG + e) * n_out] = omg[e];
          }
        }
        out[O_MUT * n_out] = mut;
        out[O_F1 * n_out] = f1;
        out[O_F2 * n_out] = f2;
      }
    }
    // this step's upper i-faces are the next one's lower ones
    const int swap = ilo;
    ilo = ihi;
    ihi = swap;
    s = s_up;
  }
  CLOCK(tid == 0, 66);
  cp_async_wait_all();
}

using KernelFn = void (*)(Fields, Params, Plan);

KernelFn kernel_of(int model) {
  switch (model) {
    case SST: return viscous_tiles<SST>;
    case WILCOX: return viscous_tiles<WILCOX>;
    case WALE: return viscous_tiles<WALE>;
    case LAMINAR: return viscous_tiles<LAMINAR>;
    default: return nullptr;
  }
}

// the plan of tj x tk columns and seg planes for a block of ni x nj x nk,
// or false for a tile the kernel does not take
bool make_plan(int model, int ni, int nj, int nk, int tj, int tk, int seg,
               Plan* L) {
  if (ni < 1 || nj < 1 || nk < 1 || tj < 1 || tk < 1 || seg < 1 ||
      tj * tk > MAX_COLUMNS || 3 * tj * tk + tj + tk > THREADS ||
      8 * smem_doubles(model, tj, tk) > MAX_SMEM)
    return false;
  L->tj = tj;
  L->tk = tk;
  L->seg = seg;
  L->ntk = (nk + tk - 1) / tk;
  L->ntiles = ((nj + tj - 1) / tj) * L->ntk;
  return true;
}

// raise the kernel's dynamic shared memory limit to `bytes` where needed
int allow_smem(KernelFn fn, int model, int64_t bytes) {
  static int64_t allowed[4] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
  if (bytes <= allowed[model]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  allowed[model] = bytes;
  return 0;
}

}  // namespace

// The viscous residual of one block: one launch on `stream`.  model is the
// eddy-viscosity branch (enum Model: 0 SST, 1 Wilcox, 2 WALE, 3 laminar);
// prim has 7 equations for the first two and 5 for the others, out 29 or 21
// channels, and the face statics 27 channels for WALE, else 26.  The tiles
// are tj x tk (j, k) columns (tj * tk <= 128) and seg i-planes
// (kernels/viscous_march.py viscous_tile).  params is a HOST array of
// NPARAMS doubles in the order of struct Params.  Returns
// cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for an unknown model or a tile it does not take.
extern "C" int viscous_march_f64(int model, const double* prim,
                                 const double* t, const double* mu,
                                 const double* face_i, const double* face_j,
                                 const double* face_k, const double* cell,
                                 double* out, int ni, int nj, int nk, int g,
                                 int tj, int tk, int seg,
                                 const double* params, void* stream) {
  const KernelFn fn = kernel_of(model);
  Plan L;
  if (fn == nullptr || !make_plan(model, ni, nj, nk, tj, tk, seg, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  double* dst = reinterpret_cast<double*>(&P);
  for (int n = 0; n < NPARAMS; ++n) dst[n] = params[n];
  Fields F;
  F.prim = prim;
  F.t = t;
  F.mu = mu;
  F.face[0] = face_i;
  F.face[1] = face_j;
  F.face[2] = face_k;
  F.cell = cell;
  F.out = out;
  F.NJ = nj + 2 * g;
  F.NK = nk + 2 * g;
  F.nc = static_cast<int64_t>(ni + 2 * g) * F.NJ * F.NK;
  F.ncell = static_cast<int64_t>(ni) * nj * nk;
  F.nf[0] = static_cast<int64_t>(ni + 1) * nj * nk;
  F.nf[1] = static_cast<int64_t>(ni) * (nj + 1) * nk;
  F.nf[2] = static_cast<int64_t>(ni) * nj * (nk + 1);
  F.ni = ni;
  F.nj = nj;
  F.nk = nk;
  F.g = g;
  const int64_t bytes = 8 * smem_doubles(model, tj, tk);
  const int err = allow_smem(fn, model, bytes);
  if (err != 0) return err;
  const unsigned ctas =
      static_cast<unsigned>(L.ntiles) * ((ni + seg - 1) / seg);
  void* args[] = {&F, &P, &L};
  const cudaError_t launched = cudaLaunchKernel(
      reinterpret_cast<const void*>(fn), dim3(ctas), dim3(THREADS), args,
      static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

#ifdef VISCOUS_PHASE_CLOCKS
// the measurement build's clocks of the last launch: CLOCKS values for each
// of the first `ctas` CTAs (at most CLOCK_CTAS) into the host array `out`
extern "C" int viscous_march_clocks(long long* out, int ctas) {
  if (ctas < 0 || ctas > CLOCK_CTAS)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, phase_clocks, sizeof(long long) * CLOCKS * ctas));
}
#endif

// What a launch of branch `model` with tj x tk tiles takes: out[0] the
// dynamic shared memory of a CTA in bytes, out[1] the CTAs that fit one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[2] the threads of a
// CTA, out[3] the registers of a thread and out[4] its local (spill)
// memory in bytes (cudaFuncGetAttributes).  Returns a cudaError_t.
extern "C" int viscous_march_info(int model, int tj, int tk, int* out) {
  const KernelFn fn = kernel_of(model);
  Plan L;
  if (fn == nullptr || !make_plan(model, 1, tj, tk, tj, tk, 1, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes = 8 * smem_doubles(model, tj, tk);
  int err = allow_smem(fn, model, bytes);
  if (err != 0) return err;
  int per_sm = 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, THREADS, static_cast<size_t>(bytes)));
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = static_cast<int>(cudaFuncGetAttributes(&attr, fn));
  if (err != 0) return err;
  out[0] = static_cast<int>(bytes);
  out[1] = per_sm;
  out[2] = THREADS;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
