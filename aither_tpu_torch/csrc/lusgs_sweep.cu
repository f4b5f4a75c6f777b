// LU-SGS hyperplane sweep for NVIDIA Hopper (sm_90a), float64.
//
// Replaces the TPU kernel aither_tpu/solver/pallas_sweep.py::sweep
// (pallas_call at pallas_sweep.py:342), variants (a) and (b): scalar
// LU-SGS, one species, SST k-omega (7 equations), Rusanov off-diagonal,
// without and with the lagged opposite-side term `extra` (matrixSweeps > 1,
// pallas_sweep.py:315-324).
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
// the inviscid, viscous and turbulence face spectral radii times du).  The
// neighbour in the block interior was updated on the previous plane; a
// neighbour in a connection ghost holds the swapped du.  du is updated IN
// PLACE: a plane reads only neighbour planes, so one launch per plane on
// one stream is the whole dependency chain.
//
// Layout: prim, du (7, NI, NJ, NK) and mu, mut, f1 (NI, NJ, NK) padded
// blocks; b, extra (7, ni, nj, nk), inv_f, inv_t (ni, nj, nk) physical.
// The host
// plan (SweepPlan) lists each plane's
// cells (padded and physical flat indices) and per cell and direction the
// face normal, area and centre distance (stat, 15 doubles) and whether the
// neighbour contributes (mask).  A masked face is skipped by a branch, never
// multiplied by zero: a ghost state there may be garbage and 0*NaN is NaN.
//
// What bounds it on the card: at 1M cells the bytes a forward+backward pair
// must move take well under 1 ms at 3.35 TB/s (kernels/lusgs_sweep.py
// sweep_cost; PERF.md), while
// the pair is 2 x (ni+nj+nk-2) dependent plane launches per block of a few
// hundred to a few thousand cells each.  Neither bandwidth nor the launch
// floor (an empty dependent launch takes ~2.3 us on the H100, 3.2 ms for
// 1,400 planes) holds it at its ~27 ms: each plane's one wave of serial
// per-thread work does; a persistent kernel is the next step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NEQ = 7;
constexpr int IT = 5;          // first turbulence equation
constexpr int NSTAT = 5;       // nx, ny, nz, mag, dist per direction
constexpr int THREADS = 128;

struct Phys {
  double R, cv, cp, hf, gamma, prandtl, prt, scaling;
  double tmin_k, tmin_w, sigma_k1, sigma_k2;
};

struct Fields {
  const double* __restrict__ prim;
  double* du;
  const double* __restrict__ mu;
  const double* __restrict__ mut;
  const double* __restrict__ f1;
  const double* __restrict__ b;
  const double* __restrict__ extra;  // nullptr: no lagged term
  const double* __restrict__ inv_f;
  const double* __restrict__ inv_t;
  const int* __restrict__ cells;
  const int* __restrict__ phys_cells;
  const double* __restrict__ stat;
  const unsigned char* __restrict__ mask;
  int64_t nc;        // NI*NJ*NK: equation stride of the padded fields
  int64_t ncp;       // ni*nj*nk: equation stride of b
  int64_t stride[3]; // flat step of one cell in i, j, k
};

// F(q).n per unit area (aither_tpu flux.physical_flux)
__device__ __forceinline__ void physical_flux(const Phys& ph,
                                              const double q[NEQ], double n0,
                                              double n1, double n2,
                                              double f[NEQ]) {
  const double rho = q[0], u = q[1], v = q[2], w = q[3], p = q[4];
  const double vn = u * n0 + v * n1 + w * n2;
  const double t = p / (ph.R * rho);
  const double h0 = ph.hf + ph.cp * t + 0.5 * (u * u + v * v + w * w);
  const double rvn = rho * vn;
  f[0] = rho * vn;
  f[1] = rvn * u + p * n0;
  f[2] = rvn * v + p * n1;
  f[3] = rvn * w + p * n2;
  f[4] = rvn * h0;
  f[5] = rvn * q[5];
  f[6] = rvn * q[6];
}

// q + du in conserved variables, back to primitives
// (aither_tpu state.update_prim_with_cons, one species)
__device__ __forceinline__ void update_prim(const Phys& ph,
                                            const double q[NEQ],
                                            const double dq[NEQ],
                                            double out[NEQ]) {
  const double rho = q[0], u = q[1], v = q[2], w = q[3], p = q[4];
  const double t = p / (ph.R * rho);
  const double e = ph.hf + ph.cv * t + 0.5 * (u * u + v * v + w * w);
  const double c0 = rho + dq[0];
  double mf = c0 / c0;             // species renormalisation (== 1)
  mf = mf < 0.0 ? 0.0 : mf;
  const double r = c0 * (mf / mf);
  const double uu = (rho * u + dq[1]) / r;
  const double vv = (rho * v + dq[2]) / r;
  const double ww = (rho * w + dq[3]) / r;
  const double se = (rho * e + dq[4]) / r - 0.5 * (uu * uu + vv * vv + ww * ww);
  const double tu = (se - ph.hf) / ph.cv;
  const double k = (rho * q[5] + dq[5]) / r;
  const double om = (rho * q[6] + dq[6]) / r;
  out[0] = r;
  out[1] = uu;
  out[2] = vv;
  out[3] = ww;
  out[4] = ph.R * r * tu;
  out[5] = k < ph.tmin_k ? ph.tmin_k : k;     // NaN propagates
  out[6] = om < ph.tmin_w ? ph.tmin_w : om;
}

// scalar Rusanov off-diagonal product of one neighbour, added to acc
// (aither_tpu implicit.offdiagonal_scalar, viscous, SST)
template <bool FORWARD>
__device__ __forceinline__ void add_offdiagonal(
    const Phys& ph, const double q[NEQ], const double dq[NEQ], double n0,
    double n1, double n2, double mag, double dist, double mu, double mut,
    double f1, double acc[NEQ]) {
  double qu[NEQ], fu[NEQ], fq[NEQ];
  update_prim(ph, q, dq, qu);
  physical_flux(ph, qu, n0, n1, n2, fu);
  physical_flux(ph, q, n0, n1, n2, fq);
  const double rho = q[0];
  const double vn = q[1] * n0 + q[2] * n1 + q[3] * n2;
  const double a = sqrt(ph.gamma * q[4] / rho);
  const double max_term = fmax(4.0 / (3.0 * rho), ph.gamma / rho);
  const double sr = 0.5 * mag * (fabs(vn) + a) +
                    mag / dist * max_term *
                        (ph.scaling * (mu / ph.prandtl + mut / ph.prt));
  const double sk = f1 * ph.sigma_k1 + (1.0 - f1) * ph.sigma_k2;
  const double sr_t =
      0.5 * mag * fabs(FORWARD ? vn + fabs(vn) : vn - fabs(vn)) +
      ph.scaling * (mag / dist) / rho * (mu + sk * mut);
  const double sgn = FORWARD ? 1.0 : -1.0;
#pragma unroll
  for (int e = 0; e < IT; ++e)
    acc[e] += 0.5 * mag * (fu[e] - fq[e]) + sgn * (sr * dq[e]);
#pragma unroll
  for (int e = IT; e < NEQ; ++e) acc[e] += sgn * (sr_t * dq[e]);
}

template <bool FORWARD>
__global__ void __launch_bounds__(THREADS)
    sweep_plane(Fields fl, Phys ph, int start, int count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const int s = start + t;
  const int64_t c = fl.cells[s];
  const int64_t pc = fl.phys_cells[s];
  double acc[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) acc[e] = 0.0;
  for (int d = 0; d < 3; ++d) {
    if (!fl.mask[3 * s + d]) continue;
    const int64_t nb = FORWARD ? c - fl.stride[d] : c + fl.stride[d];
    const double* st = fl.stat + (3 * static_cast<int64_t>(s) + d) * NSTAT;
    double q[NEQ], dq[NEQ];
#pragma unroll
    for (int e = 0; e < NEQ; ++e) {
      q[e] = fl.prim[e * fl.nc + nb];
      dq[e] = fl.du[e * fl.nc + nb];
    }
    add_offdiagonal<FORWARD>(ph, q, dq, st[0], st[1], st[2], st[3], st[4],
                             fl.mu[nb], fl.mut[nb], fl.f1[nb], acc);
  }
  const double inv_f = fl.inv_f[pc];
  const double inv_t = fl.inv_t[pc];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    const double inv = e < IT ? inv_f : inv_t;
    double* x = fl.du + e * fl.nc + c;
    const double b = fl.b[e * fl.ncp + pc];
    if (FORWARD)
      *x = (fl.extra ? (b + acc[e]) - fl.extra[e * fl.ncp + pc]
                     : b + acc[e]) * inv;
    else if (fl.extra)
      *x = (b + fl.extra[e * fl.ncp + pc] - acc[e]) * inv;
    else
      *x = *x - acc[e] * inv;
  }
}

}  // namespace

// One whole sweep of one block: one launch per hyperplane on `stream`, in
// plane order.  plane_ptr is a HOST array of nplanes+1 offsets into the
// plane-ordered cell lists; extra may be null (variant (a)).  Returns the
// first non-zero cudaGetLastError() after a launch (0 when every launch was
// accepted).
extern "C" int lusgs_sweep_f64(
    int forward, const double* prim, double* du, const double* mu,
    const double* mut, const double* f1, const double* b,
    const double* extra, const double* inv_f, const double* inv_t,
    const int* cells,
    const int* phys_cells, const double* stat, const unsigned char* mask,
    long long nc, long long ncp, long long stride_i, long long stride_j,
    long long stride_k, int nplanes, const int* plane_ptr, double R,
    double cv, double cp, double hf, double gamma, double prandtl, double prt,
    double scaling, double tmin_k, double tmin_w, double sigma_k1,
    double sigma_k2, void* stream) {
  Fields fl{prim,  du,         mu,   mut,  f1,  b,   extra,
            inv_f, inv_t,      cells, phys_cells, stat, mask, nc,
            ncp,   {stride_i, stride_j, stride_k}};
  Phys ph{R, cv, cp, hf, gamma, prandtl, prt, scaling,
          tmin_k, tmin_w, sigma_k1, sigma_k2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int n = 0; n < nplanes; ++n) {
    const int p = forward ? n : nplanes - 1 - n;
    const int start = plane_ptr[p];
    const int count = plane_ptr[p + 1] - start;
    const int blocks = (count + THREADS - 1) / THREADS;
    if (forward)
      sweep_plane<true><<<blocks, THREADS, 0, st>>>(fl, ph, start, count);
    else
      sweep_plane<false><<<blocks, THREADS, 0, st>>>(fl, ph, start, count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The floor under one dependent plane launch: n launches of an empty plane
// (one block of THREADS threads, none with a cell) on `stream`, issued by
// the same host loop as a sweep.  Timed by chip_smoke.py; the sweep pair's
// dependent-launch floor is its plane count times this time.
extern "C" int lusgs_sweep_empty_planes(int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Fields fl{};
  Phys ph{};
  for (int p = 0; p < n; ++p) {
    sweep_plane<true><<<1, THREADS, 0, st>>>(fl, ph, 0, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
