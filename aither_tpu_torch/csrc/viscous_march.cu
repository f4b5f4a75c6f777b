// Fused viscous residual for NVIDIA Hopper (sm_90a), float64.
//
// Replaces the TPU kernel aither_tpu/solver/pallas_residual.py::
// viscous_residual_march (pallas_call at pallas_residual.py:819), all four
// eddy-viscosity branches (pallas_residual.py:490-501, :617-618): one
// species, scalar solver, central viscous reconstruction, no wall law,
// calorically perfect gas, no pressure-gradient output.  Each branch is a
// compile-time instantiation viscous_cells<MODEL>, so that none pays for
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
// interpolation), the SST eddy viscosity and blending functions, tau.n, the
// heat flux and the k / omega diffusion fluxes times the face area; then per
// cell resid -= (fa_hi - fa_lo), the 1/6 cell averages of the face gradients
// and of mut, f1, f2, and the viscous spectral radii and diagonal terms
// (with the cell's lower-face mut and f1).  No face-sized field is written:
// only the 29 cell channels (resid 7, sr_flow, sr_turb, diag_flow,
// diag_turb, vel 9, tke 3, omega 3, mut, f1, f2), or the 21 of a
// 5-equation model (resid 5, no tke and omega).
//
// Design: one thread per physical cell, one launch per block.  A thread
// evaluates its six faces with the one face routine `face_flux`, called with
// the face's own lower cell and face index, so the two cells of a face
// compute it with the same instructions on the same operands: bitwise the
// same flux, a conservative residual with no atomics and no traffic between
// threads.  The face area product is __dmul_rn so that it is never fused
// with the cell's flux difference.  The cost is twice the face arithmetic.
// The TPU kernel's march window, lane rolls, (8,128) padding and plane
// orientation exist for VMEM and the sequential grid and are not carried
// over: the face geometry (26 channels per face and direction: six CV area
// vectors, CV volume, unit normal, area, the two central coefficients and
// the face wall distance) is precomputed once per block in physical layout
// (solver/viscous.py viscous_statics).
//
// What bounds it on the card: at case B (1.05M cells, 3.2M faces) the
// inputs are 0.79 GB (the face statics 0.67 GB of it) and the outputs
// 0.24 GB: 0.31 ms at 3.35 TB/s; the arithmetic (~520 FP64 operations per
// face, ~290 per cell) is ~2.0 GFLOP, ~0.06 ms at 34 TFLOP/s.  So bytes
// bound it (kernels/viscous_march.py cost).
// Every cell re-reads ~10 neighbour cells per face from L1/L2, and the
// double face arithmetic with its FP64 divides, square roots, pow and tanh
// makes it compute- and register-heavy in practice; a tiled version sharing
// in-plane faces through shared memory is the next step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int IT = 5;          // first turbulence equation (7 equations)
constexpr int THREADS = 128;

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
  int64_t stride[3];  // padded flat step of one cell in i, j, k
  int64_t nf[3];      // faces per direction: channel stride of face[d]
  int64_t fstride[3]; // flat step from a cell's lower to its upper face
  int ni, nj, nk, g;
};

template <int NEQ>
struct Face {
  double fa[NEQ];    // flux times area (fa[0] is 0: no species diffusion)
  double vg[9];      // vg[3A+B] = d v_B / d x_A
  double kg[NEQ == 7 ? 3 : 1], wg[NEQ == 7 ? 3 : 1];  // 7 equations only
  double mut, f1, f2;
};

// Green-Gauss gradient of one field over the face-centred CV of the face
// whose lower cell is `lo` (viscous.py face_cv_gradients)
__device__ __forceinline__ void cv_gradient(const double* __restrict__ f,
                                            const double* __restrict__ S,
                                            int64_t nf, int64_t lo,
                                            int64_t sd, int64_t s1,
                                            int64_t s2, double out[3]) {
  const double qlo = f[lo], qhi = f[lo + sd];
  const double v1u = 0.25 * (qlo + qhi + f[lo + sd + s1] + f[lo + s1]);
  const double v1l = 0.25 * (qlo + qhi + f[lo + sd - s1] + f[lo - s1]);
  const double v2u = 0.25 * (qlo + qhi + f[lo + sd + s2] + f[lo + s2]);
  const double v2l = 0.25 * (qlo + qhi + f[lo + sd - s2] + f[lo - s2]);
  const double vcv = S[VCV * nf];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    out[a] = (qhi * S[(ADU + a) * nf] - qlo * S[(ADL + a) * nf] +
              v1u * S[(A1U + a) * nf] - v1l * S[(A1L + a) * nf] +
              v2u * S[(A2U + a) * nf] - v2l * S[(A2L + a) * nf]) /
             vcv;
}

__device__ __forceinline__ double clamp_min(double x, double lo) {
  return x < lo ? lo : x;  // torch.clamp(min=): NaN propagates
}

template <typename T>
__device__ __forceinline__ T pick(int d, T a0, T a1, T a2) {
  return d == 0 ? a0 : (d == 1 ? a1 : a2);
}

// One face of direction d: lower cell `lo` (padded flat index), face index
// `fidx` into face[d].  viscous.py viscous_residual's face section.
template <int MODEL>
__device__ __forceinline__ void face_flux(const Params& P, const Fields& F,
                                          int d, int64_t lo, int64_t fidx,
                                          Face<neq_of(MODEL)>& o) {
  constexpr int NEQ = neq_of(MODEL);
  const int64_t sd = pick(d, F.stride[0], F.stride[1], F.stride[2]);
  // the two transverse directions, in ijk order
  const int64_t s1 = pick(d, F.stride[1], F.stride[0], F.stride[0]);
  const int64_t s2 = pick(d, F.stride[2], F.stride[2], F.stride[1]);
  const int64_t nf = pick(d, F.nf[0], F.nf[1], F.nf[2]);
  const double* __restrict__ S = pick(d, F.face[0], F.face[1], F.face[2]) +
                                 fidx;
  const int64_t nc = F.nc;

  // central face state, turbulence clamped after the interpolation
  const double c0 = S[C0 * nf], c1 = S[C1 * nf];
  double qf[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e)
    qf[e] = c0 * F.prim[e * nc + lo + sd] + c1 * F.prim[e * nc + lo];
  if constexpr (NEQ == 7) {
    qf[IT] = clamp_min(qf[IT], P.tmin_k);
    qf[IT + 1] = clamp_min(qf[IT + 1], P.tmin_w);
  }
  const double muf = c0 * F.mu[lo + sd] + c1 * F.mu[lo];

  // face-CV gradients
  double g[3], tg[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    cv_gradient(F.prim + (1 + b) * nc, S, nf, lo, sd, s1, s2, g);
#pragma unroll
    for (int a = 0; a < 3; ++a) o.vg[3 * a + b] = g[a];
  }
  cv_gradient(F.t, S, nf, lo, sd, s1, s2, tg);
  if constexpr (NEQ == 7) {
    cv_gradient(F.prim + IT * nc, S, nf, lo, sd, s1, s2, o.kg);
    cv_gradient(F.prim + (IT + 1) * nc, S, nf, lo, sd, s1, s2, o.wg);
  }

  const double rho = qf[0];
  const double trace = o.vg[0] + o.vg[4] + o.vg[8];
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
  const double tf = qf[4] / (P.R * qf[0]);
  const double td = tf * P.t_ref;
  const double k_eff =
      P.scaling * (P.cond_c1 * pow(td, 1.5) / (td + P.cond_s) / P.k_nondim);
  const double kt = MODEL == LAMINAR ? 0.0 : mut_s * P.cp / P.prt;
  const double tgn = tg[0] * n0 + tg[1] * n1 + tg[2] * n2;
  const double e_flux =
      tau[0] * qf[1] + tau[1] * qf[2] + tau[2] * qf[3] + (k_eff + kt) * tgn;
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
}

template <int MODEL>
__global__ void __launch_bounds__(THREADS)
    viscous_cells(Fields F, Params P) {
  constexpr int NEQ = neq_of(MODEL);
  // output channels
  constexpr int O_RESID = 0, O_SRF = NEQ, O_SRT = NEQ + 1, O_DGF = NEQ + 2,
                O_DGT = NEQ + 3, O_VEL = NEQ + 4, O_TKE = O_VEL + 9,
                O_OMG = O_TKE + 3, O_MUT = O_VEL + 9 + (NEQ == 7 ? 6 : 0),
                O_F1 = O_MUT + 1, O_F2 = O_MUT + 2;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= F.ncell) return;
  const int k = static_cast<int>(t % F.nk);
  const int j = static_cast<int>((t / F.nk) % F.nj);
  const int i = static_cast<int>(t / (static_cast<int64_t>(F.nk) * F.nj));
  const int64_t c = (i + F.g) * F.stride[0] + (j + F.g) * F.stride[1] +
                    (k + F.g);
  // the cell's lower face in each direction's face grid
  const int64_t flo[3] = {
      (static_cast<int64_t>(i) * F.nj + j) * F.nk + k,
      (static_cast<int64_t>(i) * (F.nj + 1) + j) * F.nk + k,
      (static_cast<int64_t>(i) * F.nj + j) * (F.nk + 1) + k};

  const double r_c = F.prim[c];
  const double mu_c = F.mu[c];
  const double vol_c = F.cell[t];
  const double max_term = fmax(4.0 / (3.0 * r_c), P.gamma / r_c);
  const double prand = 4.0 * P.gamma / (9.0 * P.gamma - 5.0);
  const double sixth = 1.0 / 6.0;

  double resid[NEQ], vel[9], tke[3], omg[3];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) resid[e] = 0.0;
#pragma unroll
  for (int e = 0; e < 9; ++e) vel[e] = 0.0;
#pragma unroll
  for (int e = 0; e < 3; ++e) tke[e] = omg[e] = 0.0;
  double mut = 0.0, f1 = 0.0, f2 = 0.0;
  double sr_f = 0.0, sr_t = 0.0, dg_f = 0.0, dg_t = 0.0;

#pragma unroll 1
  for (int d = 0; d < 3; ++d) {
    const int64_t sd = pick(d, F.stride[0], F.stride[1], F.stride[2]);
    const int64_t fl = pick(d, flo[0], flo[1], flo[2]);
    const int64_t fs = pick(d, F.fstride[0], F.fstride[1], F.fstride[2]);
    Face<NEQ> lo, hi;
    face_flux<MODEL>(P, F, d, c - sd, fl, lo);
    face_flux<MODEL>(P, F, d, c, fl + fs, hi);
#pragma unroll
    for (int e = 0; e < NEQ; ++e) resid[e] = resid[e] - (hi.fa[e] - lo.fa[e]);
#pragma unroll
    for (int e = 0; e < 9; ++e) vel[e] = vel[e] + sixth * (lo.vg[e] + hi.vg[e]);
    if constexpr (NEQ == 7) {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        tke[e] = tke[e] + sixth * (lo.kg[e] + hi.kg[e]);
        omg[e] = omg[e] + sixth * (lo.wg[e] + hi.wg[e]);
      }
    }
    mut = mut + sixth * (lo.mut + hi.mut);
    f1 = f1 + sixth * (lo.f1 + hi.f1);
    f2 = f2 + sixth * (lo.f2 + hi.f2);

    // viscous spectral radius: mut and f1 at the cell's lower face
    const double fmag = F.cell[(1 + d) * F.ncell + t];
    const double visc_term =
        P.scaling *
        (mu_c / prand + (MODEL == LAMINAR ? 0.0 : lo.mut / P.prt));
    const double vsr = max_term * visc_term * fmag * fmag / vol_c;
    sr_f = sr_f + P.visc_coeff * vsr;
    dg_f = dg_f + 2.0 * vsr;
    if constexpr (NEQ == 7) {
      double tvsr;
      if constexpr (MODEL == WILCOX) {
        // the unlimited rho k / omega of the cell state
        const double mut_nolim =
            r_c * F.prim[IT * F.nc + c] / F.prim[(IT + 1) * F.nc + c];
        tvsr = P.scaling * (fmag * fmag / vol_c) / r_c *
               (mu_c + P.sigma_star * mut_nolim);
      } else {
        const double sk = lo.f1 * P.sigma_k1 + (1.0 - lo.f1) * P.sigma_k2;
        tvsr = P.scaling * (fmag * fmag / vol_c) / r_c * (mu_c + sk * lo.mut);
      }
      sr_t = sr_t + P.visc_coeff * tvsr;
      dg_t = dg_t + 2.0 * tvsr;
    }
  }

  double* __restrict__ out = F.out + t;
  const int64_t n = F.ncell;
#pragma unroll
  for (int e = 0; e < NEQ; ++e) out[(O_RESID + e) * n] = resid[e];
  out[O_SRF * n] = sr_f;
  out[O_SRT * n] = sr_t;
  out[O_DGF * n] = dg_f;
  out[O_DGT * n] = dg_t;
#pragma unroll
  for (int e = 0; e < 9; ++e) out[(O_VEL + e) * n] = vel[e];
  if constexpr (NEQ == 7) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      out[(O_TKE + e) * n] = tke[e];
      out[(O_OMG + e) * n] = omg[e];
    }
  }
  out[O_MUT * n] = mut;
  out[O_F1 * n] = f1;
  out[O_F2 * n] = f2;
}

}  // namespace

// The viscous residual of one block: one launch on `stream`.  model is the
// eddy-viscosity branch (enum Model: 0 SST, 1 Wilcox, 2 WALE, 3 laminar);
// prim has 7 equations for the first two and 5 for the others, out 29 or 21
// channels, and the face statics 27 channels for WALE, else 26.  params is a
// HOST array of NPARAMS doubles in the order of struct Params.  Returns
// cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for an unknown model.
extern "C" int viscous_march_f64(int model, const double* prim,
                                 const double* t,
                                 const double* mu, const double* face_i,
                                 const double* face_j, const double* face_k,
                                 const double* cell, double* out, int ni,
                                 int nj, int nk, int g, const double* params,
                                 void* stream) {
  Params P;
  double* dst = reinterpret_cast<double*>(&P);
  for (int n = 0; n < NPARAMS; ++n) dst[n] = params[n];
  const int64_t NJ = nj + 2 * g, NK = nk + 2 * g;
  const int64_t NI = ni + 2 * g;
  Fields F;
  F.prim = prim;
  F.t = t;
  F.mu = mu;
  F.face[0] = face_i;
  F.face[1] = face_j;
  F.face[2] = face_k;
  F.cell = cell;
  F.out = out;
  F.nc = NI * NJ * NK;
  F.ncell = static_cast<int64_t>(ni) * nj * nk;
  F.stride[0] = NJ * NK;
  F.stride[1] = NK;
  F.stride[2] = 1;
  F.nf[0] = static_cast<int64_t>(ni + 1) * nj * nk;
  F.nf[1] = static_cast<int64_t>(ni) * (nj + 1) * nk;
  F.nf[2] = static_cast<int64_t>(ni) * nj * (nk + 1);
  F.fstride[0] = static_cast<int64_t>(nj) * nk;
  F.fstride[1] = nk;
  F.fstride[2] = 1;
  F.ni = ni;
  F.nj = nj;
  F.nk = nk;
  F.g = g;
  const unsigned blocks =
      static_cast<unsigned>((F.ncell + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (model) {
    case SST:
      viscous_cells<SST><<<blocks, THREADS, 0, st>>>(F, P);
      break;
    case WILCOX:
      viscous_cells<WILCOX><<<blocks, THREADS, 0, st>>>(F, P);
      break;
    case WALE:
      viscous_cells<WALE><<<blocks, THREADS, 0, st>>>(F, P);
      break;
    case LAMINAR:
      viscous_cells<LAMINAR><<<blocks, THREADS, 0, st>>>(F, P);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
