// The updated states of the thermally perfect pre-pass forms, shared by the
// scalar sweep's thermally perfect forms (lusgs_sweep.cu) and the block
// sweep's thermally perfect approximateRoe ones (blusgs_sweep.cu); a
// Fields with eold and qu.  Each updated state q + du is inverted once,
// where the lanes of the earlier design inverted it once per face it is a
// neighbour across.  The pre-pass stores per physical cell its old
// specific total energy (store_old_energy, the thread of the cell's face d
// = 0) and per ghost neighbour of an unmasked face its q + du
// (store_ghost_update: its du was swapped before the launch, so no stage
// writes it); after a plane's finish the wavefront's stage inverts each
// cell's q + du once from its old energy, on a group of thermo::SPEC_LANES
// lanes that evaluate Ridder's next points together (invert_cell,
// thermo_tp.cuh temperature_from_energy_spec), into qu before the tile
// publishes the plane; the lanes read a neighbour's q + du from qu through
// L2 (__ldcg: other SMs write it during the launch).  The state arithmetic
// is roe_offdiag.cuh's (flux::old_energy, update_prim_mix,
// update_prim_mix_from); the schedule's types are sweep_wavefront.cuh's.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "roe_offdiag.cuh"
#include "sweep_wavefront.cuh"

#if SWEEP_TP
namespace tp_state {

// the work space after a form's face terms: ncp old energies eold, then
// the updated states qu (NEQ, nc) in primitive variables
// (kernels/lusgs_sweep.py work_doubles)
template <class Fields>
inline void tp_state_space(Fields& fl, double* after_faces) {
  fl.eold = after_faces;
  fl.qu = fl.eold + fl.ncp;
}

template <int NS, int NEQ, class Fields, class SP>
__device__ __forceinline__ void store_old_energy(const Fields& fl,
                                                 const SP& sp,
                                                 const wavefront::Face& fc) {
  if (fc.d != 0) return;
  const int64_t c = wavefront::padded_of(fl, fc);
  double q[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) q[e] = fl.prim[e * fl.nc + c];
  fl.eold[fc.pc] = flux::old_energy<NS, NEQ>(sp, q);
}

template <int NS, int NEQ, bool FORWARD, class Fields, class PH, class SP>
__device__ __forceinline__ void store_ghost_update(
    const Fields& fl, const PH& ph, const SP& sp,
    const wavefront::Schedule& sc, const wavefront::Face& fc,
    const wavefront::FaceOperands<NEQ>& op) {
  if (!wavefront::ghost_neighbour<FORWARD>(sc, fc)) return;
  double dq[NEQ], qn[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) dq[e] = fl.du[e * fl.nc + op.nb];
  flux::update_prim_mix<NS, NEQ>(ph, sp, op.q, dq, qn);
#pragma unroll
  for (int e = 0; e < NEQ; ++e) fl.qu[e * fl.nc + op.nb] = qn[e];
}

// the stage: cell c's (physical pc) q + du, inverted once by the
// thermo::SPEC_LANES lanes of a group (this lane r, the group's mask),
// into qu; PROBE: the step clocks' marks
template <int NS, int NEQ, bool PROBE, class Fields, class PH, class SP>
__device__ __forceinline__ void invert_cell(const Fields& fl, const PH& ph,
                                            const SP& sp, int64_t c,
                                            int64_t pc, int r,
                                            unsigned group) {
  double q[NEQ], dq[NEQ], qn[NEQ];
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    q[e] = fl.prim[e * fl.nc + c];
    dq[e] = __ldcg(fl.du + e * fl.nc + c);
  }
  const double e_old = __ldg(fl.eold + pc);
  if constexpr (PROBE) probe::mark(probe::STAGE);
  flux::update_prim_mix_from<NS, NEQ, true>(ph, sp, q, dq, e_old, qn, r,
                                            group);
  if (r == 0) {
#pragma unroll
    for (int e = 0; e < NEQ; ++e) fl.qu[e * fl.nc + c] = qn[e];
  }
  if constexpr (PROBE) probe::mark(probe::STAGE + 1);
}

}  // namespace tp_state
#endif  // SWEEP_TP
