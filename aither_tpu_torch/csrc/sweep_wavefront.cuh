// Tile-wavefront schedule of one LU-SGS sweep of one block, shared by the
// scalar (lusgs_sweep.cu) and block (blusgs_sweep.cu) sweep kernels: one
// launch walks every hyperplane i+j+k = p of the block in order, where the
// plane kernel of earlier versions took one launch per plane.
//
// The block is cut into tiles, boxes of ti x tj x tk cells (ragged at the
// upper ends).  The launch's persistent CTAs (Schedule::ctas, at most the
// tiles) take one tile after another from an atomic ticket, in the
// order of a host-built table of tiles sorted by the hyperplane of their
// origin (a topological order: a tile's lower neighbour tiles come before
// it), never by blockIdx.  Every tile a CTA waits for then belongs to a
// CTA that took an earlier ticket and is already running or done, so the
// schedule cannot deadlock however many CTAs are resident.  The tile's local
// hyperplanes run in order with __syncthreads() between them.  The
// backward sweep walks the table from its end and each tile from its upper
// corner, so both sweeps are the same code in "sweep-local" coordinates.
//
// Threads: three lanes for each (j, k) column of the tile, one per
// direction, ten columns to a warp; a column walks its cells in i, one a
// plane.  The time of a plane is the serial FP64 chain of one cell (q +
// du, the fluxes, the radii), so a cell's three off-diagonal products run
// on three lanes at once; each lane returns its product as addends, the
// lanes exchange them by shuffles and sum them in the order i, j, k from
// 0.0, and each lane finishes a third of the cell's rows.  The sum is the
// one-lane kernel's bit for bit: its running sum starts at +0.0 and never
// becomes -0.0, so a masked direction's +0.0 addend changes nothing.  A
// column keeps its lanes busy for ti of the tile's planes, so a CTA is
// small (tj x tk / 10 warps) and several share an SM.
//
// Dependencies between tiles: a cell at the lower face of its tile along
// direction d reads a cell of the lower neighbour tile P_d (upper for the
// backward sweep).  Every tile publishes its progress, the number of its
// local planes done, in state[1 + id].  Sweep-local plane q of a tile
// reads P_d's plane q + e_Pd - 1 (e_Pd: P_d's extent along d), so it may
// start once P_d has done min(q + e_Pd, planes of P_d) planes.  A tile
// publishes after every plane and a successor follows one tile length
// behind it: the critical path is the block's ni+nj+nk-2 planes, as with
// one launch per plane.  (Waiting for whole predecessor tiles instead
// makes it (tile planes) x (planes per tile) and was slower on the H100:
// PERF.md, section 6.)
//
// Coherence: du (and the thermally perfect stage's q + du) is written by other
// SMs during the launch, so the cell code reads it through L2 (__ldcg), never
// through L1, __ldg or a const __restrict__ pointer.  A tile's progress is
// published by the control thread (lane 31 of warp 0, which has no column)
// after the barrier that ends the plane: __threadfence(), then st.release.gpu
// (the pattern of cooperative groups' grid barrier); a waiting tile's control
// thread polls with ld.acquire.gpu and fences before the barrier that starts
// the plane.  Ghost du was swapped before the launch and needs no flag.  The
// ticket and the flags are zeroed by a cudaMemsetAsync on the launch's stream
// before each launch.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

// Step clocks of a sweep (kernels/lusgs_sweep.py clock_breakdown): a walk
// instantiated with PROBE, launched with Schedule::clocks set, has thread 0
// (lane 0 of column 0) read clock64() at the marks of each plane on which
// its column has a cell, and add the cycles since its previous mark to the
// mark's slot; slot BARRIER takes the cycles from a plane's last mark to
// the next plane's start (without a stage, the barrier and the flags).  The slots' meaning
// between the start and the exchange is the kernel's (mark()).  At the end
// thread 0 stores the slots and its count of such planes in row `ticket`
// (after the HEADER), and the control thread folds the launch's first
// start and last end (%globaltimer, ns) into clocks[0] (min) and clocks[1]
// (max); a pre-pass launch (lusgs_sweep.cu) folds its own into clocks[2]
// and clocks[3].
// Without clocks a PROBE walk only tests a flag in shared memory per mark,
// which still costs 1-3% of a thermally perfect sweep pair on the H100:
// only the probe's builds instantiate it (lusgs_sweep.cu SWEEP_PROBE).
namespace probe {
constexpr int SLOTS = 11;
// slots: BARRIER; ADDENDS + 0..2, the kernel's marks inside addends();
// the exchange and finish; the stage's barrier; STAGE + 0..1, the
// kernel's marks inside stage(); the barrier after the stage (PUBLISH)
// and the control thread's publication and wait with the barrier after
// them (FLAGS)
constexpr int BARRIER = 0, ADDENDS = 1, EXCHANGE = 4, FINISH = 5,
              STAGE_BARRIER = 6, STAGE = 7, PUBLISH = 9, FLAGS = 10;
constexpr int HEADER = 4;         // [0, 1] wavefront, [2, 3] pre-pass
constexpr int ROW = SLOTS + 1;    // the slots, then the planes counted
__shared__ unsigned long long acc[SLOTS];
__shared__ unsigned long long last;
__shared__ int enabled, planes, counting;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// fold this CTA's start or end into clocks[slot] (min at an even slot)
__device__ __forceinline__ void stamp(unsigned long long* clocks, int slot) {
  const unsigned long long t = globaltimer();
  if (slot % 2 == 0)
    atomicMin(clocks + slot, t);
  else
    atomicMax(clocks + slot, t);
}

// the control thread, before the walk's first barrier
__device__ __forceinline__ void begin(unsigned long long* clocks) {
  enabled = clocks != nullptr;
  planes = 0;
  counting = 0;
  for (int k = 0; k < SLOTS; ++k) acc[k] = 0;
  if (clocks) stamp(clocks, 0);
}

// add the cycles since thread 0's previous mark to slot k
__device__ __forceinline__ void mark(int k) {
  if (enabled && threadIdx.x == 0) {
    const unsigned long long now = clock64();
    if (counting) acc[k] += now - last;
    last = now;
  }
}

// thread 0 at the start of a plane (on: its column has a cell there)
__device__ __forceinline__ void plane(bool on) {
  if (enabled && threadIdx.x == 0) {
    const unsigned long long now = clock64();
    if (counting) acc[BARRIER] += now - last;
    last = now;
    counting = on;
    planes += on;
  }
}

__device__ __forceinline__ void end(unsigned long long* clocks, int row,
                                    bool ctrl) {
  if (!clocks) return;
  if (threadIdx.x == 0) {
    unsigned long long* out = clocks + HEADER + ROW * row;
    for (int k = 0; k < SLOTS; ++k) out[k] = acc[k];
    out[SLOTS] = planes;
  }
  if (ctrl) stamp(clocks, 1);
}
}  // namespace probe

namespace wavefront {

constexpr int LANES = 3;              // one per direction i, j, k
constexpr int COLUMNS_PER_WARP = 10;  // 30 lanes; lanes 30 and 31 idle
// __launch_bounds__(THREADS, 1) of both sweep kernels.  The tiles of
// implicit.sweep_tile launch 2 warps (32 x 4 x 5) or 4 (32 x 40 x 1, a
// one-cell-thick block), but the bound stays at 8 warps: with 4, ptxas
// gave the two-species scalar form more registers and its case-B pair ran
// slower on the H100, while the SST form ran the same (PERF.md, section 6)
constexpr int MAX_WARPS = 8;
constexpr int THREADS = 32 * MAX_WARPS;
constexpr int MAX_TILE_COLUMNS = COLUMNS_PER_WARP * MAX_WARPS;
constexpr int TILE_COLUMNS = 6;  // table: origin i, j, k; extent i, j, k
constexpr unsigned FULL = 0xffffffffu;
// polls of one flag before the launch is abandoned with __trap(): a
// scheduling fault then fails the launch (seconds) instead of hanging the
// card; a sound schedule waits microseconds
constexpr int MAX_POLLS = 1 << 24;

struct Schedule {
  const int* __restrict__ tiles;  // (ntiles, TILE_COLUMNS), topological
  int* state;                     // [0] ticket, [1 + id] planes done
  int ntiles;
  int ctas;      // the launch's persistent CTAs, at most ntiles
  int n[3];      // block extents ni, nj, nk
  int t[3];      // tile extents (the last tile of an axis may be shorter)
  int tg[3];     // tiles per axis
  // the step clocks (namespace probe), or null: read only by a walk
  // with PROBE
  unsigned long long* clocks;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// bring the line holding p into L2 (no register, no wait); L2 is coherent
// across SMs, so the flags' acquire operations do not drop it as they may
// drop this SM's L1
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// A CTA walks sweep-ordered tiles one after another, each CTA taking tiles
// until the tickets run out.  A plane before lane d of a column reaches a
// cell, it calls prefetch(i, j, k, d) for it (for the first cell: before
// the tile's first wait).  On each plane, for the cell of every
// column on it, lane d of the column calls addends(i, j, k, d, x), which
// adds direction d's off-diagonal product to x[0..NADD-1][0..NEQ-1] (all
// +0.0 before); then acc[e] is the sum over d = 0, 1, 2 and a = 0 ..
// NADD-1 of x[a][e] in that order from 0.0, and lane d calls
// finish(i, j, k, d, acc).  (i, j, k) are physical cell indices.  Every
// lane of a warp with a cell on the plane takes part in the exchange.
// With a stage (the thermally perfect scalar sweep and the block thermally
// perfect approximateRoe one), a barrier follows
// finish, and each group of STAGE_LANES threads (aligned lanes of a warp)
// calls stage(i, j, k, r, group) for the cell of its tile column on the
// plane (r the thread's lane in the group, group the group's lane mask);
// then a barrier, and the control thread publishes the plane, which so
// covers what the stage writes, before it waits for the predecessors' next
// plane.  Without (NoStage: every other build) a plane is published when
// the next one starts.
struct NoStage {};

template <bool FORWARD, int NEQ, int NADD, bool PROBE = false,
          int STAGE_LANES = 1, class Prefetch, class Addends, class Finish,
          class Stage = NoStage>
__device__ __forceinline__ void walk(const Schedule& sc, Prefetch prefetch,
                                     Addends addends, Finish finish,
                                     Stage stage = Stage()) {
  __shared__ int ticket;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool ctrl = tid == 31;
  constexpr bool staged = !std::is_same<Stage, NoStage>::value;
  for (;;) {
    if (ctrl) {
      ticket = atomicAdd(sc.state, 1);
      if constexpr (PROBE) probe::begin(sc.clocks);
    }
    __syncthreads();
    if (ticket >= sc.ntiles) break;
    const int row = FORWARD ? ticket : sc.ntiles - 1 - ticket;
    const int* tl = sc.tiles + TILE_COLUMNS * row;
    const int o[3] = {tl[0], tl[1], tl[2]};
    const int e[3] = {tl[3], tl[4], tl[5]};
    const int nq = e[0] + e[1] + e[2] - 2;

    // this lane's column (b, c) and direction d
    const int col = (tid >> 5) * COLUMNS_PER_WARP + lane / LANES;
    const int d = lane % LANES;
    const bool valid = lane < LANES * COLUMNS_PER_WARP && col < e[1] * e[2];
    const int b = valid ? col / e[2] : 0;
    const int c = valid ? col - b * e[2] : 0;
    // sweep-local plane of the column's first cell
    const int bc = FORWARD ? b + c : (e[1] - 1 - b) + (e[2] - 1 - c);
    const int base = lane / LANES * LANES;  // lane of direction 0

    // the control thread's view of the up-to-three predecessor tiles
    int id = 0, pred[3] = {-1, -1, -1}, ext[3] = {0, 0, 0},
        pnq[3] = {0, 0, 0}, seen[3] = {0, 0, 0};
    if (ctrl) {
      int tc[3];
      for (int a = 0; a < 3; ++a) tc[a] = o[a] / sc.t[a];
      id = (tc[0] * sc.tg[1] + tc[1]) * sc.tg[2] + tc[2];
      for (int a = 0; a < 3; ++a) {
        const int pc = tc[a] + (FORWARD ? -1 : 1);
        if (pc < 0 || pc >= sc.tg[a]) continue;
        int p[3] = {tc[0], tc[1], tc[2]};
        p[a] = pc;
        pred[a] = (p[0] * sc.tg[1] + p[1]) * sc.tg[2] + p[2];
        ext[a] = min(sc.t[a], sc.n[a] - pc * sc.t[a]);
        pnq[a] = nq - e[a] + ext[a];
      }
    }
    // control thread: wait until plane q of this tile may run
    auto wait_for = [&](int q) {
      bool waited = false;
      for (int a = 0; a < 3; ++a) {
        if (pred[a] < 0) continue;
        const int need = min(q + ext[a], pnq[a]);
        for (int polls = 0; seen[a] < need; ++polls) {
          if (polls == MAX_POLLS) __trap();
          seen[a] = load_acquire(sc.state + 1 + pred[a]);
          waited = true;
        }
      }
      if (waited) __threadfence();
    };
    auto publish = [&](int planes) {
      __threadfence();
      store_release(sc.state + 1 + id, planes);
    };

    // physical i of the column's cell at sweep-local i `as`
    auto cell_i = [&](int as) { return o[0] + (FORWARD ? as : e[0] - 1 - as); };
    if (valid && bc == 0) prefetch(cell_i(0), o[1] + b, o[2] + c, d);
    if (ctrl) wait_for(0);
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      if (!staged && ctrl && q > 0) publish(q);
      const int as = q - bc;  // sweep-local i of the column's cell
      if (valid && as + 1 >= 0 && as + 1 < e[0])
        prefetch(cell_i(as + 1), o[1] + b, o[2] + c, d);
      const bool on = valid && as >= 0 && as < e[0];
      if constexpr (PROBE) probe::plane(on);
      if (__any_sync(FULL, on)) {
        const int i = on ? cell_i(as) : o[0];
        double x[NADD][NEQ];
#pragma unroll
        for (int a = 0; a < NADD; ++a)
#pragma unroll
          for (int k = 0; k < NEQ; ++k) x[a][k] = 0.0;
        if (on) addends(i, o[1] + b, o[2] + c, d, x);
        double acc[NEQ];
#pragma unroll
        for (int k = 0; k < NEQ; ++k) {
          double sum = 0.0;
#pragma unroll
          for (int l = 0; l < LANES; ++l)
#pragma unroll
            for (int a = 0; a < NADD; ++a)
              sum += __shfl_sync(FULL, x[a][k], base + l);
          acc[k] = sum;
        }
        if constexpr (PROBE) probe::mark(probe::EXCHANGE);
        if (on) finish(i, o[1] + b, o[2] + c, d, acc);
        if constexpr (PROBE) probe::mark(probe::FINISH);
      }
      if constexpr (staged) {
        // the group of STAGE_LANES threads g takes the cells of columns g,
        // g + groups, ... of the plane, once finish has written all their
        // rows
        __syncthreads();
        if constexpr (PROBE) probe::mark(probe::STAGE_BARRIER);
        const int r = tid % STAGE_LANES;
        const unsigned group = ((1u << STAGE_LANES) - 1u) << (lane - r);
        for (int col = tid / STAGE_LANES; col < e[1] * e[2];
             col += blockDim.x / STAGE_LANES) {
          const int sb = col / e[2], scol = col - sb * e[2];
          const int sas =
              q - (FORWARD ? sb + scol : (e[1] - 1 - sb) + (e[2] - 1 - scol));
          if (sas >= 0 && sas < e[0])
            stage(cell_i(sas), o[1] + sb, o[2] + scol, r, group);
        }
        // publish the plane as soon as the stage has written it, before the
        // wait for the predecessors' next plane
        __syncthreads();
        if constexpr (PROBE) probe::mark(probe::PUBLISH);
        if (ctrl) {
          publish(q + 1);
          if (q + 1 < nq) wait_for(q + 1);
        }
      } else {
        if (ctrl && q + 1 < nq) wait_for(q + 1);
      }
      __syncthreads();
      if constexpr (PROBE && staged) probe::mark(probe::FLAGS);
    }
    if (!staged && ctrl) publish(nq);
    if constexpr (PROBE) probe::end(sc.clocks, ticket, ctrl);
    __syncthreads();   // every thread has read this tile's ticket
  }
}

// the launch of one sweep of one block: zero the ticket and the flags on
// `st`, then the schedule's ctas persistent CTAs, three lanes for each of
// a whole tile's columns, ten columns to a warp; with a stage of
// stage_lanes threads a cell (walk's STAGE_LANES), enough warps for all
// the columns' cells at once, up to THREADS.  The tickets are taken in
// topological order and every waiting CTA holds one, so the tiles a CTA
// waits for are done or held by running CTAs: no deadlock however few
// CTAs run.  The blocks of a sweep, launched on streams of their own, so
// run side by side, where a launch of a CTA a tile filled the card before
// the next block's launch started (PERF.md, section 6).
// Returns cudaGetLastError() after the launch (0 when it was accepted).
template <class Kernel, class... Args>
int launch_lanes(int stage_lanes, Kernel kernel, const Schedule& sc,
                 cudaStream_t st, Args... args) {
  cudaError_t err = cudaMemsetAsync(sc.state, 0,
                                    sizeof(int) * (1 + sc.ntiles), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int columns = sc.t[1] * sc.t[2];
  if (columns > MAX_TILE_COLUMNS) return static_cast<int>(cudaErrorInvalidValue);
  int threads = 32 * ((columns + COLUMNS_PER_WARP - 1) / COLUMNS_PER_WARP);
  if (stage_lanes > 0)
    threads = max(threads, min(THREADS, 32 * ((stage_lanes * columns + 31) /
                                              32)));
  kernel<<<sc.ctas, threads, 0, st>>>(args..., sc);
  return static_cast<int>(cudaGetLastError());
}

// face f = 3 pc + d of a sweep side, as a pre-pass launch (launch_cells,
// a thread a face) takes them: its physical cell pc (physical order
// (i, j, k), extents sc.n), the cell's indices at and the direction d
struct Face {
  int64_t pc;
  int d;
  int at[3];   // i, j, k
};

__device__ __forceinline__ Face face_of(const Schedule& sc, int64_t f) {
  Face fc;
  fc.pc = f / 3;
  fc.d = static_cast<int>(f - 3 * fc.pc);
  fc.at[2] = static_cast<int>(fc.pc % sc.n[2]);
  fc.at[1] = static_cast<int>(fc.pc / sc.n[2] % sc.n[1]);
  fc.at[0] = static_cast<int>(fc.pc / sc.n[2] / sc.n[1]);
  return fc;
}

// threads of a pre-pass CTA (launch_cells, one per face)
constexpr int PREPASS_THREADS = 128;

// stride[d] of a direction known only at run time (no local-memory index)
template <class Fields>
__device__ __forceinline__ int64_t stride_of(const Fields& fl, int d) {
  return d == 0 ? fl.stride[0] : d == 1 ? fl.stride[1] : fl.stride[2];
}

// the viscous fields of neighbour nb and the centre distance of the face
// whose stats are st, read by the forms that use them (0 otherwise)
template <int NS, int NEQ, bool VISCOUS, bool WILCOX, class Fields>
__device__ __forceinline__ void viscous_fields(const Fields& fl, int64_t nb,
                                               const double* st, double& mu,
                                               double& mut, double& f1,
                                               double& dist) {
  mu = mut = f1 = dist = 0.0;
  if constexpr (VISCOUS) {
    mu = fl.mu[nb];
    mut = fl.mut[nb];
    dist = st[4];
    if constexpr (NEQ == NS + 6 && !WILCOX) f1 = fl.f1[nb];
  }
}

// What both sweeps' pre-passes read of face f = 3 pc + d (fc =
// face_of(sc, f)) through the members their Fields share (prim, mu, mut,
// f1, stat, nc, base, stride): the cell's padded index c and its
// neighbour's nb across the face (the lower one FORWARD), the face's
// NSTAT stats st (nx, ny, nz, mag, dist), the neighbour's state q and the
// cell's qd, and viscous_fields.  A form that does not use a load (qd but
// for Roe) leaves it to the compiler to drop.
template <int NEQ>
struct FaceOperands {
  int64_t c, nb;
  const double* st;
  double q[NEQ], qd[NEQ];
  double mu, mut, f1, dist;
};

template <class Fields>
__device__ __forceinline__ int64_t padded_of(const Fields& fl,
                                             const Face& fc) {
  return fl.base + fc.at[0] * fl.stride[0] + fc.at[1] * fl.stride[1] +
         fc.at[2] * fl.stride[2];
}

template <int NSTAT, int NS, int NEQ, bool VISCOUS, bool WILCOX,
          bool FORWARD, class Fields>
__device__ __forceinline__ FaceOperands<NEQ> face_operands(const Fields& fl,
                                                          const Face& fc,
                                                          int64_t f) {
  FaceOperands<NEQ> op;
  op.c = padded_of(fl, fc);
  op.nb = FORWARD ? op.c - stride_of(fl, fc.d) : op.c + stride_of(fl, fc.d);
  op.st = fl.stat + f * NSTAT;
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    op.q[e] = fl.prim[e * fl.nc + op.nb];
    op.qd[e] = fl.prim[e * fl.nc + op.c];
  }
  viscous_fields<NS, NEQ, VISCOUS, WILCOX>(fl, op.nb, op.st, op.mu, op.mut,
                                           op.f1, op.dist);
  return op;
}

// whether the neighbour of face fc across the sweep side (the lower one
// FORWARD) is a ghost cell: the face is on the block's boundary
template <bool FORWARD>
__device__ __forceinline__ bool ghost_neighbour(const Schedule& sc,
                                                const Face& fc) {
  const int d = fc.d;
  const int at = d == 0 ? fc.at[0] : d == 1 ? fc.at[1] : fc.at[2];
  const int nd = d == 0 ? sc.n[0] : d == 1 ? sc.n[1] : sc.n[2];
  return FORWARD ? at == 0 : at == nd - 1;
}

// a fully parallel launch of `threads`-thread CTAs over n items (one per
// thread) on `st`.  Returns cudaGetLastError() after the launch.
template <class Kernel, class... Args>
int launch_cells(Kernel kernel, int64_t n, int threads, cudaStream_t st,
                 Args... args) {
  const int64_t ctas = (n + threads - 1) / threads;
  kernel<<<static_cast<unsigned>(ctas), threads, 0, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the schedule from the wrapper's HOST array sched = {ntiles, ni, nj, nk,
// ti, tj, tk, g, ctas} and the device tile table and state (1 + ntiles
// ints)
inline Schedule make_schedule(const int* sched, const int* tiles,
                              int* state,
                              unsigned long long* clocks = nullptr) {
  Schedule sc;
  sc.tiles = tiles;
  sc.state = state;
  sc.clocks = clocks;
  sc.ntiles = sched[0];
  sc.ctas = min(max(sched[8], 1), sched[0]);
  for (int a = 0; a < 3; ++a) {
    sc.n[a] = sched[1 + a];
    sc.t[a] = sched[4 + a];
    sc.tg[a] = (sc.n[a] + sc.t[a] - 1) / sc.t[a];
  }
  return sc;
}

}  // namespace wavefront
