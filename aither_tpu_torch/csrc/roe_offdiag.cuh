// Gas-state and flux functions of the two LU-SGS sweep kernels
// (lusgs_sweep.cu, blusgs_sweep.cu), float64, and the approximateRoe
// off-diagonal product both take for `inviscidFluxJacobian:
// approximateRoe`.
//
// The Roe forms replace the JAX package's scan path of
// aither_tpu/solver/implicit.py:113 roe_offdiagonal: it has no Pallas
// form (pallas_sweep.use_pallas sends approximateRoe to the scan, its
// packed sweep stream lacking the diagonal cell's state), and these
// kernels index cells directly, so they read that state.
//
// What the Roe product of one neighbour is (reference: fluxJacobian.cpp
// :240-330 RoeOffDiagonal; aither_tpu_torch/solver/implicit.py
// roe_offdiagonal):
//   mag (F_roe(q_nb + du_nb | q_diag) - F_roe(q_nb | q_diag))
//     +- (viscous-only face radius) du_nb
// where q_nb + du_nb is the neighbour's state updated in conserved
// variables, F_roe(a | b) is the Roe flux with a on the left for the lower
// neighbour (forward sweep), and the new flux swaps sides, F_roe(q_diag,
// q_nb + du_nb), for the upper one (backward sweep) while the old flux
// keeps the neighbour on the left: the reference's asymmetry, so the upper
// form is not zero at du = 0 but the side-swap offset.  The viscous radius
// is the flow one (mu/Pr + mut/Prt) on the flow rows and the turbulence
// one (mu + sigma_k mut) on the turbulence rows, with no inviscid part,
// and with dist and f1 in their right order (the reference's call site
// swaps them).  The turbulence rows of the flux change stay (unlike
// Rusanov's).  The block solver takes the same vector; its block inverse
// is unchanged.
//
// The old flux and the radii are the old states' alone, unchanged during a
// sweep, so every Roe form of both sweeps splits the product: a pre-pass
// launch, a thread per face, stores them once per face of the sweep side
// (store_roe_old_terms, roe_face_values per face), and the wavefront's
// lanes evaluate only the new flux of q + du and combine it with them
// (add_roe_change): mag (new - old), then the rows, in the plain version's
// order.  Each flux accumulates its dissipation wave by wave into its rows
// in the order of the plain version (aither_tpu_torch/solver/flux.py
// roe_flux), so that kernel and plain differ by FMA contraction only.
//
// What bounds it: per neighbour two Roe fluxes (each a Roe average, a
// square root for the ratio and one for the sound speed, two entropy
// fixes, two physical fluxes) on top of q + du, about three times the
// Rusanov product's FP64 work; the bytes add the cell's own state
// (kernels/lusgs_sweep.py sweep_cost).  What holds a sweep is its chain
// of dependent planes, on which the split leaves one Roe flux and q + du
// per neighbour (the pre-pass runs fully parallel before it).
//
// PH is the kernel's struct of one-species constants (R, cv, cp, hf,
// gamma, prandtl, prt, scaling, tmin_k, tmin_w, sigma_k1, sigma_k2), SP
// its struct of a mixture's per-species constants (R, cv, cp, hf arrays,
// and in a thermally perfect build the vibrational table vib).
//
// A build with SWEEP_TP=1 holds the thermally perfect forms of the two
// sweeps: the mixture functions below (physical_flux_mix,
// update_prim_mix) take each species' energy and enthalpy as functions of
// T (thermo_tp.cuh) and invert the energy of q + du by Ridder's method;
// both sweeps then send one species through them too (its mass fraction
// is exactly 1).  With SWEEP_ROE=1 as well (libraries lusgs_sweep_roe_tp,
// blusgs_sweep_roe_tp) the Roe flux takes its Roe state's T from the ideal
// gas law, p_r / sum_s R_s rho_s, its enthalpy sum_s mf_s h_s(T) + |v|^2/2
// and its speed of sound sqrt(cp(T) / cv(T) p_r / rho_r), and the viscous
// radius the neighbour state's cp(T) / cv(T) (the plain roe_flux and
// roe_offdiagonal of a thermally perfect Physics).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "thermo_tp.cuh"

#ifndef SWEEP_TP
#define SWEEP_TP 0
#endif

namespace flux {

constexpr double ENTROPY_FIX = 0.1;  // Harten (inviscidFlux.hpp:298)

// F(q).n per unit area (aither_tpu flux.physical_flux)
template <int NEQ, class PH>
__device__ __forceinline__ void physical_flux(const PH& ph,
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
  if constexpr (NEQ == 7) {
    f[5] = rvn * q[5];
    f[6] = rvn * q[6];
  }
}

// q + du in conserved variables, back to primitives
// (aither_tpu state.update_prim_with_cons, one species)
template <int NEQ, class PH>
__device__ __forceinline__ void update_prim(const PH& ph,
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
  out[0] = r;
  out[1] = uu;
  out[2] = vv;
  out[3] = ww;
  out[4] = ph.R * r * tu;
  if constexpr (NEQ == 7) {
    const double k = (rho * q[5] + dq[5]) / r;
    const double om = (rho * q[6] + dq[6]) / r;
    out[5] = k < ph.tmin_k ? ph.tmin_k : k;     // NaN propagates
    out[6] = om < ph.tmin_w ? ph.tmin_w : om;
  }
}

// the mixture's sum_s c_s x_s over species, from 0 in species order (the
// JAX package's Physics._sum_species)
template <int NS>
__device__ __forceinline__ double species_sum(const double c[NS],
                                              const double x[NS]) {
  double out = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) out += c[s] * x[s];
  return out;
}

// F(q).n per unit area of a mixture (aither_tpu flux.physical_flux)
template <int NS, int NEQ, class SP>
__device__ __forceinline__ void physical_flux_mix(const SP& sp,
                                                  const double q[NEQ],
                                                  double n0, double n1,
                                                  double n2, double f[NEQ]) {
  const double u = q[NS], v = q[NS + 1], w = q[NS + 2], p = q[NS + 3];
  double rho = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) rho += q[s];
  const double vn = u * n0 + v * n1 + w * n2;
  const double t = p / species_sum<NS>(sp.R, q);
  double h = 0.0;  // sum_s mf_s h_s(t)
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#if SWEEP_TP
    h += thermo::species_enthalpy(sp, s, t) * (q[s] / rho);
#else
    h += (sp.hf[s] + sp.cp[s] * t) * (q[s] / rho);
#endif
  }
  const double h0 = h + 0.5 * (u * u + v * v + w * w);
  const double rvn = rho * vn;
#pragma unroll
  for (int s = 0; s < NS; ++s) f[s] = q[s] * vn;
  f[NS] = rvn * u + p * n0;
  f[NS + 1] = rvn * v + p * n1;
  f[NS + 2] = rvn * w + p * n2;
  f[NS + 3] = rvn * h0;
#pragma unroll
  for (int e = NS + 4; e < NEQ; ++e) f[e] = rvn * q[e];
}

// the specific total energy of a mixture's state q: sum_s mf_s e_s(T) +
// |v|^2 / 2 (q + du's old energy, update_prim_mix)
template <int NS, int NEQ, class SP>
__device__ __forceinline__ double old_energy(const SP& sp,
                                             const double q[NEQ]) {
  const double u = q[NS], v = q[NS + 1], w = q[NS + 2], p = q[NS + 3];
  double rho = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) rho += q[s];
  const double t = p / species_sum<NS>(sp.R, q);
  double e = 0.0;  // sum_s mf_s e_s(t)
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#if SWEEP_TP
    e += thermo::species_energy(sp, s, t) * (q[s] / rho);
#else
    e += (sp.hf[s] + sp.cv[s] * t) * (q[s] / rho);
#endif
  }
  return e + 0.5 * (u * u + v * v + w * w);
}

// q + du of a mixture in conserved variables, the species renormalised,
// back to primitives (aither_tpu state.update_prim_with_cons), with q's
// specific total energy e (old_energy) given.  SPEC (a thermally perfect
// build): the energy is inverted by the lanes of a group together
// (thermo::temperature_from_energy_spec; this lane of the group's mask)
template <int NS, int NEQ, bool SPEC = false, class PH, class SP>
__device__ __forceinline__ void update_prim_mix_from(
    const PH& ph, const SP& sp, const double q[NEQ], const double dq[NEQ],
    double e, double out[NEQ], int lane = 0, unsigned group = 0) {
  const double u = q[NS], v = q[NS + 1], w = q[NS + 2];
  double rho = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) rho += q[s];
  double c[NS];
  double r = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    c[s] = q[s] + dq[s];
    r += c[s];
  }
  double msum = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const double m = c[s] / r;
    c[s] = m < 0.0 ? 0.0 : m;  // NaN propagates
    msum += c[s];
  }
  double r2 = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    out[s] = r * (c[s] / msum);
    r2 += out[s];
  }
  const double uu = (rho * u + dq[NS]) / r2;
  const double vv = (rho * v + dq[NS + 1]) / r2;
  const double ww = (rho * w + dq[NS + 2]) / r2;
  const double se =
      (rho * e + dq[NS + 3]) / r2 - 0.5 * (uu * uu + vv * vv + ww * ww);
#if SWEEP_TP
  double mfu[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) mfu[s] = out[s] / r2;
  double tu;
  if constexpr (SPEC)
    tu = thermo::temperature_from_energy_spec<NS>(sp, se, mfu, lane, group);
  else
    tu = thermo::temperature_from_energy<NS>(sp, se, mfu);
#else
  double hf_mix = 0.0, cv_mix = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    hf_mix += sp.hf[s] * (out[s] / r2);
    cv_mix += sp.cv[s] * (out[s] / r2);
  }
  const double tu = (se - hf_mix) / cv_mix;
#endif
  out[NS] = uu;
  out[NS + 1] = vv;
  out[NS + 2] = ww;
  out[NS + 3] = species_sum<NS>(sp.R, out) * tu;
  if constexpr (NEQ == NS + 6) {
    const double k = (rho * q[NS + 4] + dq[NS + 4]) / r2;
    const double om = (rho * q[NS + 5] + dq[NS + 5]) / r2;
    out[NS + 4] = k < ph.tmin_k ? ph.tmin_k : k;
    out[NS + 5] = om < ph.tmin_w ? ph.tmin_w : om;
  }
}

template <int NS, int NEQ, class PH, class SP>
__device__ __forceinline__ void update_prim_mix(const PH& ph, const SP& sp,
                                                const double q[NEQ],
                                                const double dq[NEQ],
                                                double out[NEQ]) {
  update_prim_mix_from<NS, NEQ>(ph, sp, q, dq, old_energy<NS, NEQ>(sp, q),
                                out);
}

// one species or a mixture: q + du, F(q).n (one species takes the
// mixture path in a thermally perfect build)
template <int NS, int NEQ, class PH, class SP>
__device__ __forceinline__ void update_state(const PH& ph, const SP& sp,
                                             const double q[NEQ],
                                             const double dq[NEQ],
                                             double out[NEQ]) {
  if constexpr (NS == 1 && !SWEEP_TP)
    update_prim<NEQ>(ph, q, dq, out);
  else
    update_prim_mix<NS, NEQ>(ph, sp, q, dq, out);
}

template <int NS, int NEQ, class PH, class SP>
__device__ __forceinline__ void state_flux(const PH& ph, const SP& sp,
                                           const double q[NEQ], double n0,
                                           double n1, double n2,
                                           double f[NEQ]) {
  if constexpr (NS == 1 && !SWEEP_TP)
    physical_flux<NEQ>(ph, q, n0, n1, n2, f);
  else
    physical_flux_mix<NS, NEQ>(sp, q, n0, n1, n2, f);
}

// Harten's entropy fix of a wave speed
__device__ __forceinline__ double entropy_fix(double ws) {
  return ws < ENTROPY_FIX ? 0.5 * (ws * ws / ENTROPY_FIX + ENTROPY_FIX) : ws;
}

// The Roe flux F_roe(ql, qr).n per unit area, Harten's entropy fix
// (aither_tpu flux.roe_flux; reference: inviscidFlux.hpp:259-382): the
// Roe average of the two states (species densities ql_s sqrt(rho_r /
// rho_l), the rest weighted by 1 and sqrt(rho_r / rho_l)), its enthalpy
// and speed of sound, the dissipation of the two acoustic waves, the
// entropy and shear waves and the turbulence waves, accumulated row by row
// in the plain version's order into f, then 0.5 (F(ql) + F(qr) - diss).
template <int NS, int NEQ, class PH, class SP>
__device__ __forceinline__ void roe_flux(const PH& ph, const SP& sp,
                                         const double ql[NEQ],
                                         const double qr[NEQ], double n0,
                                         double n1, double n2,
                                         double f[NEQ]) {
  constexpr int MX = NS, IE = NS + 3, T0 = NS + 4;
  // Roe average
  double rho_l = 0.0, rho_rt = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    rho_l += ql[s];
    rho_rt += qr[s];
  }
  const double ratio = sqrt(rho_rt / rho_l);
  const double coef = 1.0 / (1.0 + ratio);
  double rs[NS];  // the Roe state's species densities
  double rho_r = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    rs[s] = ql[s] * ratio;
    rho_r += rs[s];
  }
  const double ur = (ql[MX] + ratio * qr[MX]) * coef;
  const double vr = (ql[MX + 1] + ratio * qr[MX + 1]) * coef;
  const double wr = (ql[MX + 2] + ratio * qr[MX + 2]) * coef;
  const double pr = (ql[IE] + ratio * qr[IE]) * coef;
  const double vel2 = ur * ur + vr * vr + wr * wr;
  // enthalpy and speed of sound of the Roe state
  double h_r, a_r;
  if constexpr (NS == 1 && !SWEEP_TP) {
    const double t = pr / (ph.R * rs[0]);
    h_r = ph.hf + ph.cp * t + 0.5 * vel2;
    a_r = sqrt(ph.gamma * pr / rs[0]);
  } else {
    const double t = pr / species_sum<NS>(sp.R, rs);
    double h = 0.0, cpm = 0.0, cvm = 0.0;
#if SWEEP_TP
    double mf[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mf[s] = rs[s] / rho_r;
      h += thermo::species_enthalpy(sp, s, t) * mf[s];
    }
    thermo::cp_cv<NS>(sp, mf, t, cpm, cvm);
#else
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const double mf = rs[s] / rho_r;
      h += (sp.hf[s] + sp.cp[s] * t) * mf;
      cpm += sp.cp[s] * mf;
      cvm += sp.cv[s] * mf;
    }
#endif
    h_r = h + 0.5 * vel2;
    a_r = sqrt(cpm / cvm * pr / rho_r);
  }
  const double vn_r = ur * n0 + vr * n1 + wr * n2;

  const double d0 = qr[MX] - ql[MX], d1 = qr[MX + 1] - ql[MX + 1],
               d2 = qr[MX + 2] - ql[MX + 2];
  const double dvn = d0 * n0 + d1 * n1 + d2 * n2;
  const double dp = qr[IE] - ql[IE];
  double drho = 0.0;
#pragma unroll
  for (int s = 0; s < NS; ++s) drho += qr[s] - ql[s];
  const double a2 = a_r * a_r;

  // left moving acoustic wave
  double ws = entropy_fix(fabs(vn_r - a_r));
  double wss = ws * ((dp - rho_r * a_r * dvn) / (2.0 * a2));
#pragma unroll
  for (int s = 0; s < NS; ++s) f[s] = wss * (rs[s] / rho_r);
  f[MX] = wss * (ur - a_r * n0);
  f[MX + 1] = wss * (vr - a_r * n1);
  f[MX + 2] = wss * (wr - a_r * n2);
  f[IE] = wss * (h_r - a_r * vn_r);
#pragma unroll
  for (int e = T0; e < NEQ; ++e)
    f[e] = wss * ((ql[e] + ratio * qr[e]) * coef);

  // entropy wave (species) and shear wave
  ws = fabs(vn_r);
  const double ss = ws * (-dp / a2);
#pragma unroll
  for (int s = 0; s < NS; ++s)
    f[s] = f[s] + (ss * (rs[s] / rho_r) + ws * (qr[s] - ql[s]));
  wss = ws * (drho - dp / a2);
  f[MX] = f[MX] + wss * ur;
  f[MX + 1] = f[MX + 1] + wss * vr;
  f[MX + 2] = f[MX + 2] + wss * wr;
  f[IE] = f[IE] + wss * 0.5 * vel2;
  wss = ws * rho_r;
  f[MX] = f[MX] + wss * (d0 - dvn * n0);
  f[MX + 1] = f[MX + 1] + wss * (d1 - dvn * n1);
  f[MX + 2] = f[MX + 2] + wss * (d2 - dvn * n2);
  f[IE] = f[IE] + wss * ((ur * d0 + vr * d1 + wr * d2) - vn_r * dvn);

  // right moving acoustic wave
  ws = entropy_fix(fabs(vn_r + a_r));
  wss = ws * ((dp + rho_r * a_r * dvn) / (2.0 * a2));
#pragma unroll
  for (int s = 0; s < NS; ++s) f[s] = f[s] + wss * (rs[s] / rho_r);
  f[MX] = f[MX] + wss * (ur + a_r * n0);
  f[MX + 1] = f[MX + 1] + wss * (vr + a_r * n1);
  f[MX + 2] = f[MX + 2] + wss * (wr + a_r * n2);
  f[IE] = f[IE] + wss * (h_r + a_r * vn_r);
  if constexpr (NEQ > T0) {
    // and the turbulence waves
    const double wt = fabs(vn_r);
    const double dpa = dp / a2;
#pragma unroll
    for (int e = T0; e < NEQ; ++e) {
      const double tr = (ql[e] + ratio * qr[e]) * coef;
      f[e] = f[e] + wss * tr;
      f[e] = f[e] + wt * ((rho_r * (qr[e] - ql[e]) + tr * drho) - dpa * tr);
    }
  }

  // 0.5 (F(ql) + F(qr) - diss)
  double fl[NEQ], fr[NEQ];
  state_flux<NS, NEQ>(ph, sp, ql, n0, n1, n2, fl);
  state_flux<NS, NEQ>(ph, sp, qr, n0, n1, n2, fr);
#pragma unroll
  for (int e = 0; e < NEQ; ++e) f[e] = 0.5 * (fl[e] + fr[e] - f[e]);
}

// The viscous-only face radii of the Roe product (head of this file) of a
// neighbour with state q: the flow one (mu/Pr + mut/Prt) and, with
// turbulence equations, the turbulence one (mu + sigma_k mut); the
// neighbour state's gamma and Prandtl number from its T in a thermally
// perfect build
template <int NS, int NEQ, bool WILCOX, class PH, class SP>
__device__ __forceinline__ void roe_viscous_radii(
    const PH& ph, const SP& sp, const double q[NEQ], double mag, double dist,
    double mu, double mut, double f1, double& sr, double& sr_t) {
  constexpr int T0 = NS + 4;   // first turbulence equation
  double rho, gamma, prandtl;
  if constexpr (NS == 1 && !SWEEP_TP) {
    rho = q[0];
    gamma = ph.gamma;
    prandtl = ph.prandtl;
  } else {
    rho = 0.0;
    double cpm = 0.0, cvm = 0.0;
#pragma unroll
    for (int s = 0; s < NS; ++s) rho += q[s];
#if SWEEP_TP
    double mf[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) mf[s] = q[s] / rho;
    thermo::cp_cv<NS>(sp, mf, q[NS + 3] / species_sum<NS>(sp.R, q), cpm,
                      cvm);
#else
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      cpm += sp.cp[s] * (q[s] / rho);
      cvm += sp.cv[s] * (q[s] / rho);
    }
#endif
    gamma = cpm / cvm;
    prandtl = 4.0 * gamma / (9.0 * gamma - 5.0);
  }
  const double max_term = fmax(4.0 / (3.0 * rho), gamma / rho);
  sr = mag / dist * max_term * (ph.scaling * (mu / prandtl + mut / ph.prt));
  sr_t = 0.0;
  if constexpr (NEQ == T0 + 2) {
    // Wilcox: sigma* and the unlimited eddy viscosity of the neighbour
    const double sk = WILCOX ? ph.sigma_k1
                             : f1 * ph.sigma_k1 + (1.0 - f1) * ph.sigma_k2;
    const double mutx = WILCOX ? rho * q[T0] / q[T0 + 1] : mut;
    sr_t = ph.scaling * (mag / dist) / rho * (mu + sk * mutx);
  }
}

// The Roe product's rows from its flux change df = mag (F_new - F_old) and
// the viscous radii, added to acc.  FORWARD: the lower neighbour (positive)
template <int NS, int NEQ, bool VISCOUS, bool FORWARD>
__device__ __forceinline__ void add_roe_rows(const double df[NEQ], double sr,
                                             double sr_t,
                                             const double dq[NEQ],
                                             double acc[NEQ]) {
  constexpr int T0 = NS + 4;   // first turbulence equation
  if constexpr (!VISCOUS) {
#pragma unroll
    for (int e = 0; e < NEQ; ++e) acc[e] += df[e];
  } else {
    const double sgn = FORWARD ? 1.0 : -1.0;
#pragma unroll
    for (int e = 0; e < T0; ++e) acc[e] += df[e] + sgn * (sr * dq[e]);
#pragma unroll
    for (int e = T0; e < NEQ; ++e) acc[e] += df[e] + sgn * (sr_t * dq[e]);
  }
}

// values per face that the Roe forms' pre-pass stores: the NEQ rows of
// F_roe(q_nb | q_cell) and, viscous, the flow radius and (with turbulence
// equations) the turbulence one (kernels/lusgs_sweep.py face_values)
template <int NS, int NEQ, bool VISCOUS>
__host__ __device__ constexpr int roe_face_values() {
  return NEQ + (VISCOUS ? (NEQ == NS + 6 ? 2 : 1) : 0);
}

// The pre-pass of one face: the old Roe flux F_roe(q | qd) of the
// neighbour state q across the face (n, mag) of the cell with state qd,
// and the neighbour's viscous radii (VISCOUS), to out[v * P] for value v
// (roe_face_values).  mu, mut, f1 and dist are read only by the forms that
// use them (0 otherwise).
template <int NS, int NEQ, bool VISCOUS, bool WILCOX, class PH, class SP>
__device__ __forceinline__ void store_roe_old_terms(
    const PH& ph, const SP& sp, const double q[NEQ], const double qd[NEQ],
    double n0, double n1, double n2, double mag, double dist, double mu,
    double mut, double f1, double* out, int64_t P) {
  double fo[NEQ];
  roe_flux<NS, NEQ>(ph, sp, q, qd, n0, n1, n2, fo);
#pragma unroll
  for (int e = 0; e < NEQ; ++e) out[e * P] = fo[e];
  if constexpr (VISCOUS) {
    double sr, sr_t;
    roe_viscous_radii<NS, NEQ, WILCOX>(ph, sp, q, mag, dist, mu, mut, f1, sr,
                                       sr_t);
    out[NEQ * P] = sr;
    if constexpr (NEQ == NS + 6) out[(NEQ + 1) * P] = sr_t;
  }
}

// The new Roe flux of a neighbour's updated state qn (in primitives)
// against the cell's qd: F_roe(qn | qd) for the lower neighbour (FORWARD),
// F_roe(qd | qn) for the upper one (head of this file)
template <int NS, int NEQ, bool FORWARD, class PH, class SP>
__device__ __forceinline__ void roe_new_flux(const PH& ph, const SP& sp,
                                             const double qn[NEQ],
                                             const double qd[NEQ], double n0,
                                             double n1, double n2,
                                             double f[NEQ]) {
  if (FORWARD)
    roe_flux<NS, NEQ>(ph, sp, qn, qd, n0, n1, n2, f);
  else
    roe_flux<NS, NEQ>(ph, sp, qd, qn, n0, n1, n2, f);
}

// The approximateRoe product of one neighbour (update dq) from its new
// flux fn (roe_new_flux; overwritten) and its stored old terms old
// (store_roe_old_terms): mag (fn - old) and the radii rows, added to acc.
template <int NS, int NEQ, bool VISCOUS, bool FORWARD>
__device__ __forceinline__ void add_roe_change(double fn[NEQ],
                                               const double old[],
                                               double mag,
                                               const double dq[NEQ],
                                               double acc[NEQ]) {
#pragma unroll
  for (int e = 0; e < NEQ; ++e) fn[e] = mag * (fn[e] - old[e]);
  double sr = 0.0, sr_t = 0.0;
  if constexpr (VISCOUS) sr = old[NEQ];
  if constexpr (VISCOUS && NEQ == NS + 6) sr_t = old[NEQ + 1];
  add_roe_rows<NS, NEQ, VISCOUS, FORWARD>(fn, sr, sr_t, dq, acc);
}

}  // namespace flux
