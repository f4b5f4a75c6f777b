// Thermally perfect gas of the two LU-SGS sweep kernels (lusgs_sweep.cu,
// blusgs_sweep.cu built with -DSWEEP_TP=1), float64: per species the
// energy, enthalpy, cv and cp with their vibrational parts, and the
// mixture's temperature from its energy by Ridder's method.
//
// The plain version is aither_tpu_torch/physics/models.py (Physics with
// thermo_model thermallyPerfect), a port of aither_tpu/physics/models.py
// :193-306 (reference: thermodynamic.hpp:129-166, thermodynamic.cpp
// :101-141, utility.hpp:130-184).  Each function keeps the plain
// version's order of operations:
//   e_s(T)  = hf_s + cv_s T + R_s sum_m theta_m / (exp(theta_m / T) - 1)
//   h_s(T)  = hf_s + cp_s T + (the same vibrational sum times R_s)
//   cv_s(T) = cv_s + R_s sum_m (tv / sinh(tv))^2,  tv = theta_m / (2 T)
//   cp_s(T) = cp_s + (the same)
// with cv_s = R_s n_s and cp_s = R_s (n_s + 1) the calorically perfect
// constants and the modes summed from 0 in the fluid table's order.
//
// The species table SP has R[NS], cv[NS], cp[NS], hf[NS] and the
// vibrational table vib: every species' vibrational temperatures
// (nondimensional) one after another, species s's modes m = first[s] ..
// first[s + 1] - 1, so that a species may have any number of modes (a
// fluid file lists any count; the loops' bound is a run-time one) and a
// deck up to VIB_MODES in all.  The table passes by value in the kernel's
// parameters, read through the constant cache.
//
// The temperature inversion is the plain version's loop: the bracket
// [RIDDER_LO, RIDDER_HI], at most RIDDER_ITERS iterations, each with two
// energy evaluations, stopping once the bracket is within RIDDER_TOL or a
// residual is exactly 0 (the plain version freezes such a point and runs
// on: its values do not change again); T is the last evaluation point x4,
// not a root refined to another tolerance, and an unbracketed point gives
// RIDDER_HI.  sign() is numpy's and torch's: 0 for +-0 and NaN for NaN
// (CUDA's copysign would give +-1 at 0).

#pragma once

#include <cuda_runtime.h>

namespace thermo {

constexpr double RIDDER_LO = 1.0e-8, RIDDER_HI = 1.0e4, RIDDER_TOL = 1.0e-8;
constexpr int RIDDER_ITERS = 64;

// modes the table holds, all species of a deck together: 2 KB, which
// keeps a sweep's kernel parameters within their 4 KB at 16 species (the
// sweeps' static_assert; the fluid database's 15 species have 24 modes;
// kernels/lusgs_sweep.py VIB_MODES refuses a deck of more)
constexpr int VIB_MODES = 256;

// the vibrational table of NS species (head of this file)
template <int NS>
struct Vib {
  int first[NS + 1];
  double theta[VIB_MODES];
};

// fill vib from a host array of the NS mode counts followed by every
// mode, species after species; false if a count is not a whole number or
// the modes are more than VIB_MODES
template <int NS>
inline bool read_vib(const double* src, Vib<NS>& vib) {
  vib.first[0] = 0;
  for (int s = 0; s < NS; ++s) {
    const double c = src[s];
    if (!(c >= 0.0 && c <= VIB_MODES) || c != static_cast<int>(c))
      return false;
    vib.first[s + 1] = vib.first[s] + static_cast<int>(c);
  }
  if (vib.first[NS] > VIB_MODES) return false;
  for (int m = 0; m < VIB_MODES; ++m)
    vib.theta[m] = m < vib.first[NS] ? src[NS + m] : 0.0;
  return true;
}

__device__ __forceinline__ double sign_of(double x) {
  return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : x);   // +-0 -> +-0, NaN -> NaN
}

// sum over species s's modes of theta / (exp(theta / T) - 1)
template <class SP>
__device__ __forceinline__ double vib_energy(const SP& sp, int s, double t) {
  double acc = 0.0;
  for (int m = sp.vib.first[s]; m < sp.vib.first[s + 1]; ++m) {
    const double th = sp.vib.theta[m];
    acc = acc + th / (exp(th / t) - 1.0);
  }
  return acc;
}

// sum over species s's modes of (tv / sinh(tv))^2, tv = theta / (2 T)
template <class SP>
__device__ __forceinline__ double vib_cpcv(const SP& sp, int s, double t) {
  double acc = 0.0;
  for (int m = sp.vib.first[s]; m < sp.vib.first[s + 1]; ++m) {
    const double tv = sp.vib.theta[m] / (2.0 * t);
    const double r = tv / sinh(tv);
    acc = acc + r * r;
  }
  return acc;
}

template <class SP>
__device__ __forceinline__ double species_energy(const SP& sp, int s,
                                                 double t) {
  return sp.hf[s] + sp.cv[s] * t + sp.R[s] * vib_energy(sp, s, t);
}

template <class SP>
__device__ __forceinline__ double species_enthalpy(const SP& sp, int s,
                                                   double t) {
  return sp.hf[s] + sp.cp[s] * t + sp.R[s] * vib_energy(sp, s, t);
}

template <class SP>
__device__ __forceinline__ double species_cv(const SP& sp, int s, double t) {
  return sp.cv[s] + sp.R[s] * vib_cpcv(sp, s, t);
}

template <class SP>
__device__ __forceinline__ double species_cp(const SP& sp, int s, double t) {
  return sp.cp[s] + sp.R[s] * vib_cpcv(sp, s, t);
}

// the mixture's energy sum_s e_s(T) mf_s from 0 in species order; one
// species is its own (Physics.mix)
template <int NS, class SP>
__device__ __forceinline__ double energy(const SP& sp, const double mf[NS],
                                         double t) {
  if constexpr (NS == 1) {
    return species_energy(sp, 0, t);
  } else {
    double out = 0.0;
#pragma unroll
    for (int s = 0; s < NS; ++s) out += species_energy(sp, s, t) * mf[s];
    return out;
  }
}

// the mixture's cp and cv at T (sum_s cp_s(T) mf_s, sum_s cv_s(T) mf_s)
template <int NS, class SP>
__device__ __forceinline__ void cp_cv(const SP& sp, const double mf[NS],
                                      double t, double& cp, double& cv) {
  if constexpr (NS == 1) {
    const double v = vib_cpcv(sp, 0, t);
    cp = sp.cp[0] + sp.R[0] * v;
    cv = sp.cv[0] + sp.R[0] * v;
  } else {
    cp = 0.0;
    cv = 0.0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const double v = vib_cpcv(sp, s, t);
      cp += (sp.cp[s] + sp.R[s] * v) * mf[s];
      cv += (sp.cv[s] + sp.R[s] * v) * mf[s];
    }
  }
}

// T of the mixture mf with specific internal energy e: Ridder's method
// (head of this file)
template <int NS, class SP>
__device__ __forceinline__ double temperature_from_energy(
    const SP& sp, double e, const double mf[NS]) {
  double x1 = RIDDER_LO, x2 = RIDDER_HI;
  double f1 = e - energy<NS>(sp, mf, x1);
  double f2 = e - energy<NS>(sp, mf, x2);
  if (!(sign_of(f1) != sign_of(f2))) return RIDDER_HI;
  double x4 = RIDDER_HI;
  for (int it = 0; it < RIDDER_ITERS; ++it) {
    const double x3 = 0.5 * (x1 + x2);
    const double f3 = e - energy<NS>(sp, mf, x3);
    const double denom = sqrt(fabs(f3 * f3 - f1 * f2)) + 1.0e-300;
    x4 = x3 + (x3 - x1) * (sign_of(f1 - f2) * f3) / denom;
    const double f4 = e - energy<NS>(sp, mf, x4);
    if (sign_of(f4) != sign_of(f3)) {
      x1 = x3;
      f1 = f3;
      x2 = x4;
      f2 = f4;
    } else if (sign_of(f4) != sign_of(f1)) {
      x2 = x4;
      f2 = f4;
    } else {
      x1 = x4;
      f1 = f4;
    }
    if (fabs(x2 - x1) <= RIDDER_TOL || f3 == 0.0 || f4 == 0.0) break;
  }
  return x4;
}

// temperature_from_energy on a group of SPEC_LANES lanes (aligned lanes
// of one warp, their mask `group`, this lane `r`): the same iterations and
// the same evaluation points, so the same T bit for bit, with each
// iteration's two dependent energy evaluations made one.  Once x4 is
// known, the next iteration's x3 is the midpoint of one of three brackets,
// [x3, x4], [x1, x4] or [x4, x2], by the signs of f4; lane 0 evaluates f4
// while lanes 1-3 evaluate the three midpoints, and the lanes exchange
// the residuals by shuffles.  Every lane computes every bracket value, so
// the lanes of a group take the same branches.  The first evaluations,
// RIDDER_LO, RIDDER_HI and their midpoint, run at once too.  (Two more
// lanes a point, each evaluating half of a mixture's species, ran a
// seven-species step 16% longer on the H100: the halves' branches are
// taken one after the other by the warp.)
constexpr int SPEC_LANES = 4;

template <int NS, class SP>
__device__ __forceinline__ double temperature_from_energy_spec(
    const SP& sp, double e, const double mf[NS], int r, unsigned group) {
  auto res = [&](double x) { return e - energy<NS>(sp, mf, x); };
  auto from = [&](double v, int lane) {
    return __shfl_sync(group, v, lane, SPEC_LANES);
  };
  double x1 = RIDDER_LO, x2 = RIDDER_HI;
  double fv = res(r == 0 ? x1 : r == 1 ? x2 : 0.5 * (x1 + x2));
  double f1 = from(fv, 0), f2 = from(fv, 1);
  double f3 = from(fv, 2);   // at the first iteration's x3
  if (!(sign_of(f1) != sign_of(f2))) return RIDDER_HI;
  double x4 = RIDDER_HI;
  for (int it = 0; it < RIDDER_ITERS; ++it) {
    const double x3 = 0.5 * (x1 + x2);
    const double denom = sqrt(fabs(f3 * f3 - f1 * f2)) + 1.0e-300;
    x4 = x3 + (x3 - x1) * (sign_of(f1 - f2) * f3) / denom;
    fv = res(r == 0   ? x4
             : r == 1 ? 0.5 * (x3 + x4)
             : r == 2 ? 0.5 * (x1 + x4)
                      : 0.5 * (x4 + x2));
    const double f4 = from(fv, 0);
    const double g1 = from(fv, 1), g2 = from(fv, 2), g3 = from(fv, 3);
    const double f3_now = f3;
    if (sign_of(f4) != sign_of(f3)) {
      x1 = x3;
      f1 = f3;
      x2 = x4;
      f2 = f4;
      f3 = g1;
    } else if (sign_of(f4) != sign_of(f1)) {
      x2 = x4;
      f2 = f4;
      f3 = g2;
    } else {
      x1 = x4;
      f1 = f4;
      f3 = g3;
    }
    if (fabs(x2 - x1) <= RIDDER_TOL || f3_now == 0.0 || f4 == 0.0) break;
  }
  return x4;
}

}  // namespace thermo
