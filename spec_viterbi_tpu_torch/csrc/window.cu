// Window kernels of the chunked-halo state-sharded decode for Hopper
// (sm_90a), each with a plain C entry point loaded through ctypes by
// spec_viterbi_tpu_torch/parallel/fused_tp.py.
//
//   svt_scores_window  replaces spec_viterbi_tpu/parallel/fused_tp.py::
//                      FusedTPDecoder._pallas_win: c masked steps of the
//                      scores recurrence on the state window of each
//                      shard of a banded operator.
//   svt_path_window    replaces fused_tp.py::FusedTPDecoder.
//                      _path_pallas_win: the same steps with (value,
//                      source) pairs under svt_path's tie rule, writing the
//                      interior rows' int16 backpointers.
//
// Geometry. A banded operator (diagonals only) of n states is cut into
// shards of `block` rows. In the padded row space [h_lo + n + h_hi] (guard
// rows +inf), shard r's window is rows [r*block, r*block + n_win): its own
// block at window rows [h_lo, h_lo + block) and halo rows either side.
// Information moves at most max|d| rows a step, so after c steps the
// interior rows are exact (their dependency cone, c*max|d| <= the halo,
// stays in the window) and only they are written out. A source outside the
// window gives no candidate: the carry in shared memory has g >= max|d|
// rows of +inf on each side, w + inf = inf, and neither fminf nor take()
// ever prefers such a candidate, so the guard rows act as a bounds check.
// Window edges thus become +inf where the TPU kernel's cyclic roll brought
// in garbage; either way only halo rows see it, and they are exchanged
// anew.
//
// Launch forms. Carry rows of window s start at row s*block of v_in and
// v_out, operand rows at op_row0 + s*block of dv [D][stride] and em
// [E][stride]:
// - a local group (K shards held by one process) launches S = K windows
//   over the global padded carry [stride, B], op_row0 = 0; v_in and v_out
//   are two such carries, and the halo exchange is swapping them;
// - a rank of a distributed group launches S = 1 over its own [n_win, B]
//   window buffer, op_row0 = rank*block, and exchanges halos with NCCL.
//
// Pointers of svt_path_window are `window source + base`, base = ptr_base +
// s*block, written to bp[t][b][s*block + (i - h_lo)] for interior row i: a
// local group passes ptr_base = -h_lo and gets global pointers into one
// [T-1, B, n] tensor (the layout svt_path writes, walked by svt_backtrace);
// a rank passes 0 and gets window-local pointers [T-1, B, block]. Dead rows
// store 0 and frozen steps store `window row + base`, as svt_path.
//
// What bounds them is each lane's per-step chain (a pass over the window
// and a barrier) and, once every lane-window of a launch is resident, the
// SMs' shared-memory traffic; bytes are far below HBM rate. Taken apart on
// an H100 (PERF.md), the parent kernel's step was mostly its per-candidate
// bounds check and the global reads on the chain (observation, then the
// emission row and the diagonal values it selects); its 256-thread CTAs,
// one per lane-window, also took two waves for the local form's 2,048. So:
// - no bounds check: the +inf guard rows above, and D (1..MAX_DIAG) a
//   template parameter, so the diagonals unroll;
// - no global memory on the step chain (the staged arm): the window's
//   emission table [E][n_win] and diagonal values [D][n_win] are copied to
//   shared memory once a launch and shared by the LANES lanes of a CTA,
//   each a group of LANE_THREADS threads with its own named barrier, so
//   lanes of one CTA freeze independently; 4 such CTAs an SM hold the local
//   form's lane-windows in one wave. The next step's observation is read
//   one step ahead;
// - the global arm, for windows whose staged tables and carries exceed
//   STAGED_SMEM (fused_tp.py chooses the arm from the shapes, once): one
//   lane a CTA of 256 threads, the tables read through L1, the emission
//   row's address known one step ahead;
// - svt_path_window takes two neighbouring rows a thread and stores their
//   int16 pointers as one 32-bit store (h_lo, block, n_win, bp_width and
//   the pointer columns are even), frozen steps too; svt_scores_window takes
//   one row at a time, which ran 1.36 against 2.15 us/step for row pairs
//   (PERF.md);
// - the staged arm reads and writes the carries with neighbouring threads
//   on the CTA's lanes of one row, so a row of its 4 lanes is one 16-byte
//   segment of the [rows, B] carry.
// Each candidate is one f32 add, rounded once, the min exact in any order,
// and the emission add rounds once: both arms are bit-equal to the plain
// versions and to the unsharded kernels.

#include <algorithm>
#include <cstdlib>

#include "common.cuh"

namespace {

// the staged arm's shared memory a CTA at most (ops/_build.py mirrors it):
// four CTAs of 4 lanes fit an SM
constexpr size_t STAGED_SMEM = 56 * 1024;

struct WindowArgs {
  const float* dv;  // [D][stride]
  const float* em;  // [E][stride]
  int stride, op_row0, block, h_lo;
  int n_em;  // emission rows (staged arm: copied to shared memory)
  int g;     // guard rows each side of a carry
  const float* v_in;
  const int* obs;
  const int* lengths;
  float* v_out;
  short* bp;  // svt_path_window only
  int bp_width, ptr_base, batch, steps;
};

// The two arms: lanes a CTA and threads a lane.
// The staged scores kernel keeps 4 CTAs an SM (32 registers a thread):
// the local form's 2,048 lane-windows at 512 lanes in one wave.
template <bool STAGED>
struct Arm {
  static constexpr int LANES = STAGED ? 4 : 1;
  static constexpr int LANE_THREADS = STAGED ? 128 : 256;
  static constexpr int THREADS = LANES * LANE_THREADS;
  static constexpr int MIN_CTAS = STAGED ? 4 : 1;
};

// the barrier of lane l of the CTA: its LANE_THREADS threads only. The id
// in a register makes the CTA reserve all 16 named barriers, which holds an
// SM to 4 CTAs: the staged arm's 4 of 512 threads fill it anyway, and the
// immediate ids of a switch cost 5-10% a step on an H100 (PERF.md).
template <int LANES, int LANE_THREADS>
__device__ __forceinline__ void lane_sync(int l) {
  if constexpr (LANES == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(l + 1), "n"(LANE_THREADS) : "memory");
}

// min over the D diagonal candidates of row i; dvs holds row i of
// diagonal q at dvs[q * ds + i], cur has its guard rows
template <int D>
__device__ __forceinline__ float window_min(const ScoresDesc& desc, const float* dvs, int ds,
                                            const float* cur, int i) {
  float a = INFINITY;
#pragma unroll
  for (int q = 0; q < D; ++q) a = fminf(a, dvs[q * ds + i] + cur[i - desc.diag_off[q]]);
  return a;
}

// (value, source) of row i under the tie rule
template <int D>
__device__ __forceinline__ void window_pair(const ScoresDesc& desc, const float* dvs, int ds,
                                            const float* cur, int i, float& u, int& s) {
  u = INFINITY;
  s = INT_MAX;
#pragma unroll
  for (int q = 0; q < D; ++q) {
    const int j = i - desc.diag_off[q];
    take(u, s, dvs[q * ds + i] + cur[j], j);
  }
}

// shared memory of a CTA: the staged tables, then LANES double-buffered
// carries of n + 2g rows
size_t window_smem(bool staged, int n, int n_diag, int n_em, int g) {
  const size_t tables = staged ? (size_t)(n_em + n_diag) * n : 0;
  const int lanes = staged ? Arm<true>::LANES : Arm<false>::LANES;
  return (tables + (size_t)lanes * 2 * (n + 2 * g)) * sizeof(float);
}

template <int D, bool STAGED, bool PATH>
__global__ void __launch_bounds__(Arm<STAGED>::THREADS, PATH ? 1 : Arm<STAGED>::MIN_CTAS)
window_kernel(const ScoresDesc desc, const WindowArgs a) {
  constexpr int LANES = Arm<STAGED>::LANES;
  constexpr int LT = Arm<STAGED>::LANE_THREADS;
  constexpr int THREADS = Arm<STAGED>::THREADS;
  extern __shared__ float smem[];  // staged: em_s [E][n], dv_s [D][n]; then carries [LANES][2][n + 2g]
  const int n = desc.n;  // n_win
  const int l = threadIdx.x / LT;
  const int tid = threadIdx.x % LT;
  const int b0 = blockIdx.x * LANES;
  const int b = b0 + l;
  const size_t row0 = (size_t)blockIdx.y * a.block;
  const float* dv_w = a.dv + a.op_row0 + row0;
  const float* em_w = a.em + a.op_row0 + row0;
  float* em_s = smem;
  float* dv_s = em_s + (STAGED ? a.n_em * n : 0);
  const int span = n + 2 * a.g;
  float* carries = dv_s + (STAGED ? D * n : 0);

  // a launch runs only c steps, so its fixed costs count: the loads below
  // are unrolled to keep several in flight
  if (STAGED) {
    // the window's tables, once a launch, shared by the CTA's lanes
    for (int i = threadIdx.x; i < n; i += THREADS) {
#pragma unroll
      for (int q = 0; q < D; ++q) dv_s[q * n + i] = dv_w[(size_t)q * a.stride + i];
#pragma unroll 4
      for (int e = 0; e < a.n_em; ++e) em_s[e * n + i] = em_w[(size_t)e * a.stride + i];
    }
  }
  // the carries, guard rows +inf; row r of the CTA's lanes side by side
  for (int k = threadIdx.x; k < LANES * 2 * span; k += THREADS) carries[k] = INFINITY;
  __syncthreads();
#pragma unroll 4
  for (int k = threadIdx.x; k < LANES * n; k += THREADS) {
    const int r = k / LANES, lk = k % LANES;
    if (b0 + lk < a.batch) carries[lk * 2 * span + a.g + r] = a.v_in[(row0 + r) * a.batch + b0 + lk];
  }
  __syncthreads();

  if (b < a.batch) {
    const int my_steps = lane_steps(a.lengths, b, a.steps);
    const int base = a.ptr_base + (int)row0;
    const float* dvs = STAGED ? dv_s : dv_w;
    const int ds = STAGED ? n : a.stride;
    float* cur = carries + l * 2 * span + a.g;
    float* nxt = cur + span;
    int o_next = my_steps > 0 ? a.obs[b] : 0;
    for (int t = 0; t < my_steps; ++t) {
      const int o = o_next;
      if (t + 1 < my_steps) o_next = a.obs[(size_t)(t + 1) * a.batch + b];
      const float* em_row = STAGED ? em_s + o * n : em_w + (size_t)o * a.stride;
      short2* bp_row = PATH ? reinterpret_cast<short2*>(a.bp + ((size_t)t * a.batch + b) * a.bp_width + row0)
                            : nullptr;
      if (PATH) {
        // two neighbouring rows a thread, their pointers one 32-bit store;
        // n, h_lo and block are even, so a pair is interior or not as a whole
        for (int i = 2 * tid; i < n; i += 2 * LT) {
          float u0, u1;
          int s0, s1;
          window_pair<D>(desc, dvs, ds, cur, i, u0, s0);
          window_pair<D>(desc, dvs, ds, cur, i + 1, u1, s1);
          nxt[i] = em_row[i] + u0;
          nxt[i + 1] = em_row[i + 1] + u1;
          const int k = i - a.h_lo;
          if (k >= 0 && k < a.block)
            bp_row[k >> 1] = make_short2((short)(u0 < INFINITY ? s0 + base : 0),
                                         (short)(u1 < INFINITY ? s1 + base : 0));
        }
      } else {
        for (int i = tid; i < n; i += LT) nxt[i] = em_row[i] + window_min<D>(desc, dvs, ds, cur, i);
      }
      lane_sync<LANES, LT>(l);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    if (PATH) {
      // frozen steps keep the carry and store identity pointers
      const int id0 = a.h_lo + base;
      for (int t = my_steps; t < a.steps; ++t) {
        short2* bp_row = reinterpret_cast<short2*>(a.bp + ((size_t)t * a.batch + b) * a.bp_width + row0);
        for (int k = 2 * tid; k < a.block; k += 2 * LT)
          bp_row[k >> 1] = make_short2((short)(k + id0), (short)(k + 1 + id0));
      }
    }
    // the lane's last carry is in the buffer `cur` points to; copy its
    // interior back where the CTA-wide store below reads it
    // (the lane's last barrier ordered every read of that buffer)
    if (cur != carries + l * 2 * span + a.g)
      for (int i = a.h_lo + tid; i < a.h_lo + a.block; i += LT) nxt[i] = cur[i];
  }
  __syncthreads();
#pragma unroll 4
  for (int k = threadIdx.x; k < LANES * a.block; k += THREADS) {
    const int r = a.h_lo + k / LANES, lk = k % LANES;
    if (b0 + lk < a.batch) a.v_out[(row0 + r) * a.batch + b0 + lk] = carries[lk * 2 * span + a.g + r];
  }
}

typedef void (*WindowFn)(const ScoresDesc, const WindowArgs);

template <bool STAGED, bool PATH>
WindowFn window_fn(int n_diag) {
  switch (n_diag) {
    case 1: return window_kernel<1, STAGED, PATH>;
    case 2: return window_kernel<2, STAGED, PATH>;
    case 3: return window_kernel<3, STAGED, PATH>;
    case 4: return window_kernel<4, STAGED, PATH>;
    case 5: return window_kernel<5, STAGED, PATH>;
    case 6: return window_kernel<6, STAGED, PATH>;
    case 7: return window_kernel<7, STAGED, PATH>;
    case 8: return window_kernel<8, STAGED, PATH>;
    default: return nullptr;
  }
}
static_assert(MAX_DIAG == 8, "window_fn instantiates D = 1..MAX_DIAG");

WindowFn pick(int n_diag, bool staged, bool path) {
  if (path) return staged ? window_fn<true, true>(n_diag) : window_fn<false, true>(n_diag);
  return staged ? window_fn<true, false>(n_diag) : window_fn<false, false>(n_diag);
}

// guard rows: max|d|
int guard_of(const ScoresDesc* desc) {
  int g = 0;
  for (int q = 0; q < desc->n_diag; ++q) g = std::max(g, std::abs(desc->diag_off[q]));
  return g;
}

int launch(const ScoresDesc* desc, WindowArgs a, int staged, int shards, void* stream, bool path) {
  const int n = desc->n;
  // the pointer pairs: WindowTables.build keeps all of these even
  if ((n | a.h_lo | a.block | a.bp_width) & 1) return (int)cudaErrorInvalidValue;
  const WindowFn fn = pick(desc->n_diag, staged != 0, path);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  a.g = guard_of(desc);
  const size_t smem = window_smem(staged != 0, n, desc->n_diag, a.n_em, a.g);
  if (staged && smem > STAGED_SMEM) return (int)cudaErrorInvalidValue;
  int rc = set_smem((const void*)fn, smem);
  if (rc) return rc;
  const int lanes = staged ? Arm<true>::LANES : Arm<false>::LANES;
  const int threads = staged ? Arm<true>::THREADS : Arm<false>::THREADS;
  fn<<<dim3((a.batch + lanes - 1) / lanes, shards), threads, smem, (cudaStream_t)stream>>>(*desc, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// staged = 1 runs the staged arm, 0 the global arm; n_em is the emission
// table's row count E.
int svt_scores_window(const ScoresDesc* desc, const float* dv, const float* em, int stride,
                      int op_row0, int block, int h_lo, const float* v_in, const int* obs,
                      const int* lengths, float* v_out, int batch, int shards, int steps, int n_em,
                      int staged, void* stream) {
  const WindowArgs a{dv, em, stride, op_row0, block, h_lo, n_em, 0, v_in, obs, lengths, v_out,
                     nullptr, 0, 0, batch, steps};
  return launch(desc, a, staged, shards, stream, false);
}

int svt_path_window(const ScoresDesc* desc, const float* dv, const float* em, int stride,
                    int op_row0, int block, int h_lo, const float* v_in, const int* obs,
                    const int* lengths, float* v_out, short* bp, int bp_width, int ptr_base,
                    int batch, int shards, int steps, int n_em, int staged, void* stream) {
  const WindowArgs a{dv, em, stride, op_row0, block, h_lo, n_em, 0, v_in, obs, lengths, v_out,
                     bp, bp_width, ptr_base, batch, steps};
  return launch(desc, a, staged, shards, stream, true);
}

// Registers a thread, resident CTAs an SM and lanes a CTA of a window
// kernel (which = 0 scores, 1 path; staged = 1 the staged arm) for a
// window of n rows, n_diag diagonals up to max|d| = max_abs_off and E =
// n_em emission rows.
int svt_window_occupancy(int which, int staged, int n, int n_diag, int max_abs_off, int n_em,
                         int* regs, int* ctas_per_sm, int* lanes_per_cta) {
  const WindowFn fn = which == 0 || which == 1 ? pick(n_diag, staged != 0, which == 1) : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = window_smem(staged != 0, n, n_diag, n_em, max_abs_off);
  int rc = set_smem((const void*)fn, smem);
  if (rc) return rc;
  cudaFuncAttributes attr;
  rc = (int)cudaFuncGetAttributes(&attr, (const void*)fn);
  if (rc) return rc;
  *regs = attr.numRegs;
  *lanes_per_cta = staged ? Arm<true>::LANES : Arm<false>::LANES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, (const void*)fn, staged ? Arm<true>::THREADS : Arm<false>::THREADS, smem);
}

}  // extern "C"
