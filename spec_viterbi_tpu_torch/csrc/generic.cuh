// The generic arms of the masked scores and path kernels (svt_scores_masked,
// svt_path, and svt_scores_variant's flagged copies of the scores arm): one
// kernel template, generic_kernel<L, C_CAP, PATH, FLAGS, SMEM_TAB>, for any
// fused-eligible operator (diagonals, dense rows, dense columns, at most
// MAX_RES residual entries), launched by csrc/scores.cu and csrc/path.cu.
//
// The design, and why (PERF.md, measured on an H100): re-reading the
// operator's value vectors every lane and step cost 2.3 of 6.65 us/step at
// 512 lanes, and a column reduce over the carry just read, with a serial
// patch of the special rows behind a second barrier, most of the rest.
//
// - L lanes share a CTA of GEN_THREADS threads (L = 1, 2 or 4, chosen at
//   launch, gen_pick below). The operator's D + R + C value vectors are
//   copied into shared memory once a launch, so a step reads them from
//   there, and each read serves the CTA's L lanes. Where they do not fit
//   beside the L carries they stay in global memory (L2), the last resort.
//   Only the emission row stays a per-lane, per-step stream. The L carries
//   are interleaved ([n][L]), so one 16-byte shared-memory load gives a
//   candidate's source for all four lanes and one store writes a row.
// - One barrier a step. Thread tid owns the same rows every step (unit u =
//   tid + m * BULK, rows RPU * u .. RPU * u + RPU - 1). The bulk pass
//   skips the special rows (dense-column targets, residual destinations) and
//   folds each new value into the next step's per-column partial minima,
//   min_j(cv_c[j] + v_new[j]), one partial a thread, lane and column,
//   reduced across each warp (a transposed butterfly: the L * C partials
//   share the shuffles) into a double-buffered slot. The patch warp,
//   the last (it has the fewest rows; in the path arm none), forms the
//   special rows in the same step, before the barrier, from the previous
//   carry: it merges the column minima of that carry from the slots the
//   previous step filled, takes the residual candidates, writes its rows
//   and folds them into its partials.
//   Step 0's column minima come from a seeding reduce over v0.
// - The path arm (PATH) takes every candidate as a (value, source) pair
//   under take() and the column partials under pair_min(): each column
//   candidate is its own rounded sum fl(cv_c[j] + v[j]) and pair_min is a
//   total order, so the folded argmin is the oracle's, lowest row first.
//   A thread owns row pairs (RPU = 2), so where n is even a pair's two
//   int16 pointers go out as one 32-bit store; a pair holding a special
//   row, or any row where n is odd, stores its rows one at a time.
// - A lane that is done freezes: its rows are carried forward from buffer to
//   buffer unchanged and it stores no pointer (its adds still run with the
//   CTA's other lanes). The CTA runs until its longest lane ends; the bucket
//   plans sort lanes by length, so neighbouring lanes end close together.
//   The path arm writes a frozen lane's identity pointers after the loop.
//
// Every candidate is one f32 add rounded once and min is exact, so the
// scores equal scores_masked_plain's bit for bit and the pointers
// path_plain's. Values are compared as floats: -0.0 ties with +0.0.
//
// What bounds it now: the chain of a step, not bytes or operations. At 512
// lanes (4 a CTA, one CTA of 16 warps an SM) the scores arm takes 3.6
// us/step and the path arm 5.4 on a 2,405-state model with one diagonal, one
// dense row and column and three residual entries (parent 6.3 and 8.6); the
// dense columns and the patch warp take 1.0-1.2 us of a scores step
// (PERF.md, S4). Four choices measured there: the tables are read with
// shared-memory loads (SMEM_TAB; a pointer that may be shared or global
// takes generic loads, 5-10% slower), the unit loop is unrolled by two with
// a compile-time stride, the emission is read through the read-only path
// (ldg below), and in the path arm the patch warp takes no bulk rows (BULK).
#pragma once

#include <type_traits>

#include "common.cuh"

#define GEN_THREADS 512
#define GEN_WARPS (GEN_THREADS / 32)
#define GEN_PATCH_WARP (GEN_WARPS - 1)

// Compile-time flags of the scores arm, 0 in production. Each other value
// (one at a time; ops/probes.py mirrors the bits) changes or strips one part
// of the step, for the per-component cost breakdown of the probes (entry
// point svt_scores_variant, which replaces the B1 bodies that the TPU probes
// patch in at spec_viterbi_tpu/ops/fused_pallas.py:1323):
//   BF16_OPS     dv, rv, cv and the emission table stored as bf16 and
//                upcast (residual values rounded to bf16 in the descriptor):
//                the all-bf16 arm of scripts/exp_roofline.py::
//                _make_bf16_kernel. The tables are upcast once, into shared
//                memory (a bf16 launch whose tables do not fit there is
//                refused), so what it now changes a step is the emission
//                stream's width.
//   EM_STAGED    the emission rows of the next EM_STAGE_STEPS steps copied
//                into shared memory with cp.async one block ahead, double-
//                buffered: the counterpart of exp_roofline.py::
//                _make_embatch_kernel's one wide emission fetch per grid
//                cell. Exact.
//   NO_COLS      no dense-column folds and merges (the special rows keep
//                their bulk and residual candidates): scripts/
//                exp_kernel_variants.py::make_variant_kernel's no_cols.
//   NO_EM        one constant emission row, em[0]: its no_mxu.
//   NO_SPECIAL   no column folds, no residual candidates, no patch warp: the
//                special rows take their bulk candidates in the bulk pass
//                (its no_spec; the step has one barrier either way, so this
//                strips the patch and the column work, not a barrier).
//   SHORT_CHAIN  em + dv and em + rv formed before the carry is read, so the
//                chain after the carry load is one add and the mins:
//                exp_kernel_variants.py::make_shortchain_kernel. Rounds
//                differently (timing only).
// The ablations give wrong scores on purpose; each flag's plain version in
// ops/probes.py computes what it computes, and the kernel equals it.
#define VF_BF16_OPS 1
#define VF_EM_STAGED 2
#define VF_NO_COLS 4
#define VF_NO_EM 8
#define VF_NO_SPECIAL 16
#define VF_SHORT_CHAIN 32
#define EM_STAGE_STEPS 4

// The operand type of a flag set: bf16 under BF16_OPS, else f32.
template <int FLAGS>
using ScoresElem = typename std::conditional<(FLAGS & VF_BF16_OPS) != 0, __nv_bfloat16, float>::type;

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// One lane's accumulator: a value (scores) or a (value, source) pair
// (paths) under the tie rule of take().
template <bool PATH>
struct Acc;

template <>
struct Acc<false> {
  float v;
  __device__ __forceinline__ void reset() { v = INFINITY; }
  __device__ __forceinline__ void add(float c, int) { v = fminf(v, c); }
  __device__ __forceinline__ short ptr() const { return 0; }
};

template <>
struct Acc<true> {
  float v;
  int s;
  __device__ __forceinline__ void reset() {
    v = INFINITY;
    s = INT_MAX;
  }
  __device__ __forceinline__ void add(float c, int cs) { take(v, s, c, cs); }
  // a row no finite candidate reaches points to 0
  __device__ __forceinline__ short ptr() const { return (short)(v < INFINITY ? s : 0); }
};

// One dense column's running min over the rows of a thread (scores) or
// (min, lowest argmin) (paths).
template <bool PATH>
struct ColPart;

template <>
struct ColPart<false> {
  float v;
  __device__ __forceinline__ void reset() { v = INFINITY; }
  // rows in increasing order (the bulk pass) or any order: min is exact
  __device__ __forceinline__ void fold_up(float x, int) { v = fminf(v, x); }
  __device__ __forceinline__ void fold(float x, int) { v = fminf(v, x); }
  __device__ __forceinline__ void warp_reduce() { v = warp_min(v); }
  // take the partial of lane ^ o
  __device__ __forceinline__ void merge_xor(int o) { v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o)); }
};

template <>
struct ColPart<true> {
  float v;
  int i;
  __device__ __forceinline__ void reset() {
    v = INFINITY;
    i = INT_MAX;
  }
  // a thread's bulk rows come in increasing order, so strict < keeps the
  // lowest row among equal sums
  __device__ __forceinline__ void fold_up(float x, int j) {
    if (x < v) {
      v = x;
      i = j;
    }
  }
  __device__ __forceinline__ void fold(float x, int j) { pair_min(v, i, x, j); }
  __device__ __forceinline__ void merge_xor(int o) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    pair_min(v, i, ov, oi);
  }
  __device__ __forceinline__ void warp_reduce() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) merge_xor(o);
  }
};

// The warp's minima of 2H partials a lane, in the rounds of a transposed
// butterfly: at offset o a lane keeps the half of its partials that its bit
// o selects and takes the partner's copy of that half, so 2H partials take
// H + H/2 + ... + 1 shuffles, not 2H * 5; the last partial left then
// takes the rounds that remain. Afterwards lane x holds the minimum of
// partial x / (32 / 2H) (2H a power of two, at most 32).
template <int H, bool PATH>
__device__ __forceinline__ void transposed_min(ColPart<PATH>* v, int lane, int o) {
  if constexpr (H >= 1) {
    const bool hi = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      ColPart<PATH> keep = hi ? v[j + H] : v[j];
      const ColPart<PATH> send = hi ? v[j] : v[j + H];
      if constexpr (PATH) {
        const float ov = __shfl_xor_sync(0xffffffffu, send.v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, send.i, o);
        keep.fold(ov, oi);
      } else {
        keep.fold(__shfl_xor_sync(0xffffffffu, send.v, o), 0);
      }
      v[j] = keep;
    }
    transposed_min<H / 2, PATH>(v, lane, o >> 1);
  } else {
    for (; o > 0; o >>= 1) v[0].merge_xor(o);
  }
}

// One carry row of a CTA's L lanes: the carry is lane-interleaved ([n][L]),
// so a row's L values are one 4-, 8- or 16-byte shared-memory access.
template <int L>
struct Row;

template <>
struct Row<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = *p; }
  __device__ __forceinline__ void store(float* p) const { *p = v[0]; }
};

template <>
struct Row<2> {
  float v[2];
  __device__ __forceinline__ void load(const float* p) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

template <>
struct Row<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// An emission value through the read-only path: such a load cannot alias
// the carry's stores, so the unit loop unrolled by two may move one unit's
// loads ahead of the other's stores (with plain loads the ragged buckets
// ran 12-17% and the uniform paths 2-5% slower on an H100, PERF.md).
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) { return ld(p); }

// The double-buffered per-warp column partials: slot p holds the minima of
// the carry that step p's parity reads.
template <int L, int C_CAP, bool PATH>
struct ColSlots {
  float v[2][GEN_WARPS][L][C_CAP];
};

template <int L, int C_CAP>
struct ColSlots<L, C_CAP, true> {
  float v[2][GEN_WARPS][L][C_CAP];
  int i[2][GEN_WARPS][L][C_CAP];
};

// The launch parameters the kernel needs beyond the descriptor.
struct GenArgs {
  const void* dv;  // [D][n]
  const void* rv;  // [R][n]
  const void* cv;  // [C][n]
  const void* em;  // [E][n]
  const float* v0;  // [n][batch]
  const int* obs;  // [steps][batch]
  const int* lengths;  // [batch] or nullptr
  float* out;  // [n][batch]
  short* bp;  // [steps][batch][n] (paths)
  int batch, steps;
};

// SMEM_TAB: the value vectors are copied into shared memory and read there
// (else read from global memory).
template <int L, int C_CAP, bool PATH, int FLAGS, bool SMEM_TAB>
__global__ void __launch_bounds__(GEN_THREADS, 1)
generic_kernel(const ScoresDesc desc, const GenArgs a) {
  using T = ScoresElem<FLAGS>;
  constexpr bool kStaged = FLAGS & VF_EM_STAGED;
  constexpr bool kNoEm = FLAGS & VF_NO_EM;
  constexpr bool kSpecial = !(FLAGS & VF_NO_SPECIAL);
  constexpr bool kCols = kSpecial && !(FLAGS & VF_NO_COLS);
  constexpr bool kShort = FLAGS & VF_SHORT_CHAIN;
  constexpr int RPU = PATH ? 2 : 1;
  constexpr int U = EM_STAGE_STEPS;
  static_assert(!PATH || FLAGS == 0, "the path arm has no variants");
  static_assert(MAX_SPECIAL <= 64, "the patch warp holds at most two special rows a lane");
  static_assert(SMEM_TAB || std::is_same<T, float>::value, "bf16 tables are read from shared memory");

  extern __shared__ __align__(16) float smem[];
  __shared__ ColSlots<L, C_CAP, PATH> slots;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * L;
  const int n = desc.n, n_diag = desc.n_diag, n_row = desc.n_row, n_col = desc.n_col;
  const int batch = a.batch, steps = a.steps;
  const int n_tab = n_diag + n_row + n_col;
  float* const carry = smem;  // [2][n][L]: lane l of row i at (p * n + i) * L + l
  float* const tabs = smem + 2 * L * n;  // [D + R + C][n] under SMEM_TAB
  // EM_STAGED: [2][U][L][n] after the tables
  float* const stage = tabs + (SMEM_TAB ? n_tab * n : 0);

  int len[L];
  int t_end = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    len[l] = b0 + l < batch ? lane_steps(a.lengths, b0 + l, steps) : 0;
    t_end = max(t_end, len[l]);
  }

  // the operator's value vectors, once a launch
  const T* const gdv = (const T*)a.dv;
  const T* const grv = (const T*)a.rv;
  const T* const gcv = (const T*)a.cv;
  if (SMEM_TAB) {
    const int dn = n_diag * n, drn = (n_diag + n_row) * n;
    for (int x = tid; x < n_tab * n; x += GEN_THREADS)
      tabs[x] = ld(x < dn ? gdv + x : x < drn ? grv + (x - dn) : gcv + (x - drn));
  }
  // SMEM_TAB is known at compile time, so these are shared-memory loads
  const float* __restrict__ dvt = SMEM_TAB ? tabs : (const float*)a.dv;
  const float* __restrict__ rvt = SMEM_TAB ? tabs + n_diag * n : (const float*)a.rv;
  const float* __restrict__ cvt = SMEM_TAB ? tabs + (n_diag + n_row) * n : (const float*)a.cv;

  // The threads of the bulk pass: in the path arm all but the patch warp,
  // whose patch is then its step's whole chain (on an H100 the path arm's
  // step 18-30% shorter where the operator has special rows, 1% longer
  // where it has none; the scores arm, whose patch is lighter, gained
  // nothing, PERF.md).
  constexpr int BULK = PATH ? GEN_THREADS - 32 : GEN_THREADS;
  // the special rows among this thread's: bit m * RPU + k for row
  // RPU * (tid + m * BULK) + k
  unsigned long long spbits = 0;
  if (kSpecial) {
    for (int s = 0; s < desc.n_special; ++s) {
      const int r = desc.sp_row[s], u = r / RPU;
      if (u % BULK == tid) spbits |= 1ull << ((u / BULK) * RPU + r % RPU);
    }
  }
  // the patch warp's special rows (lane, lane + 32): the columns that
  // target each and the residual entries into it
  int prow[2] = {-1, -1}, pcol[2] = {0, 0}, pres[2] = {0, 0};
  if (kSpecial && warp == GEN_PATCH_WARP) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int s = lane + 32 * k;
      if (s < desc.n_special) {
        const int r = desc.sp_row[s];
        prow[k] = r;
        for (int c = 0; c < n_col; ++c)
          if (desc.col_idx[c] == r) pcol[k] |= 1 << c;
        for (int z = 0; z < desc.n_res; ++z)
          if (desc.res_dst[z] == r) pres[k] |= 1 << z;
      }
    }
  }

  // the incoming carries: a row's L lanes are neighbours in v0 too
  for (int x = tid; x < n * L; x += GEN_THREADS) {
    const int i = x / L, l = x - i * L;
    if (b0 + l < batch) carry[x] = a.v0[(size_t)i * batch + b0 + l];
  }

  // EM_STAGED: request the emission rows of steps [t_first, t_first + U)
  // into block `blk` of the stage
  auto request = [&](int blk, int t_first) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      for (int u = 0; u < U && t_first + u < len[l]; ++u) {
        const float* src =
            (const float*)a.em + (size_t)__ldg(a.obs + (size_t)(t_first + u) * batch + b0 + l) * n;
        float* dst = stage + (((blk & 1) * U + u) * L + l) * n;
        for (int c = tid * 4; c < n; c += GEN_THREADS * 4) cp_async16(dst + c, src + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if constexpr (kStaged) request(0, 0);
  __syncthreads();

  ColPart<PATH> cp[L * C_CAP];  // lane l, column c at l * C_CAP + c
  auto reset_parts = [&]() {
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int c = 0; c < C_CAP; ++c) cp[l * C_CAP + c].reset();
  };
  // each warp's partials of the carry a step made, into slot `p`: with
  // L * C_CAP a power of two, by the transposed butterfly (a frozen lane's
  // partials go along; no one reads them)
  constexpr int NV = L * C_CAP;
  constexpr bool kTransposed = NV <= 32 && (NV & (NV - 1)) == 0;
  auto publish = [&](int p, const bool* act) {
    if constexpr (kTransposed) {
      transposed_min<NV / 2, PATH>(cp, lane, 16);
      constexpr int span = 32 / NV;  // lanes that hold each partial
      if (lane % span == 0) {
        const int k = lane / span, l = k / C_CAP, c = k % C_CAP;
        slots.v[p][warp][l][c] = cp[0].v;
        if constexpr (PATH) slots.i[p][warp][l][c] = cp[0].i;
      }
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        if (!act[l]) continue;
#pragma unroll
        for (int c = 0; c < C_CAP; ++c) {
          if (c < n_col) {
            cp[l * C_CAP + c].warp_reduce();
            if (lane == 0) {
              slots.v[p][warp][l][c] = cp[l * C_CAP + c].v;
              if constexpr (PATH) slots.i[p][warp][l][c] = cp[l * C_CAP + c].i;
            }
          }
        }
      }
    }
  };

  // the seeding reduce: the column minima of v0
  if constexpr (kCols) {
    bool act0[L];
#pragma unroll
    for (int l = 0; l < L; ++l) act0[l] = len[l] > 0;
    reset_parts();
    for (int i = tid; i < n; i += GEN_THREADS) {
      Row<L> v;
      v.load(carry + i * L);
#pragma unroll
      for (int c = 0; c < C_CAP; ++c) {
        if (c < n_col) {
          const float w = cvt[c * n + i];
#pragma unroll
          for (int l = 0; l < L; ++l) cp[l * C_CAP + c].fold(w + v.v[l], i);
        }
      }
    }
    publish(0, act0);
    __syncthreads();
  }

  int o_cur[L];
#pragma unroll
  for (int l = 0; l < L; ++l) o_cur[l] = len[l] > 0 ? __ldg(a.obs + b0 + l) : 0;

  for (int t = 0; t < t_end; ++t) {
    const int p = t & 1;
    const float* const cur = carry + p * n * L;
    float* const nxt = carry + (p ^ 1) * n * L;
    bool act[L];
    int o_next[L];
    const T* er[L];
    bool all_act = true;  // else a frozen lane's rows are carried forward
#pragma unroll
    for (int l = 0; l < L; ++l) {
      act[l] = t < len[l];
      all_act &= act[l];
      o_next[l] = t + 1 < len[l] ? __ldg(a.obs + (size_t)(t + 1) * batch + b0 + l) : 0;
    }
    if constexpr (kStaged) {
      if (t % U == 0) {
        // this block's rows arrived one block ago; request the next block
        // into the other buffer, whose readers passed the last barrier
        request((t / U) + 1, t + U);
        asm volatile("cp.async.wait_group 1;\n" ::);
        __syncthreads();
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if constexpr (kStaged)
        er[l] = (const T*)(stage + ((((t / U) & 1) * U + t % U) * L + l) * n);
      else if constexpr (kNoEm)
        er[l] = (const T*)a.em;
      else
        er[l] = (const T*)a.em + (size_t)o_cur[l] * n;
    }

    // row i's diagonal and dense-row candidates for every lane; SHORT_CHAIN
    // folds the emission e into each value first
    auto bulk = [&](int i, Acc<PATH>* acc, const float* e) {
#pragma unroll
      for (int l = 0; l < L; ++l) acc[l].reset();
      for (int q = 0; q < n_diag; ++q) {
        const int j = i - desc.diag_off[q];
        if (j >= 0 && j < n) {
          const float w = dvt[q * n + i];
          Row<L> v;
          v.load(cur + j * L);
#pragma unroll
          for (int l = 0; l < L; ++l) acc[l].add((kShort ? e[l] + w : w) + v.v[l], j);
        }
      }
      for (int r = 0; r < n_row; ++r) {
        const float w = rvt[r * n + i];
        const int s = desc.row_idx[r];
        Row<L> v;
        v.load(cur + s * L);
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l].add((kShort ? e[l] + w : w) + v.v[l], s);
      }
    };
    // the L lanes' new values of row i (a frozen lane keeps its old one)
    auto put = [&](int i, const float* vn) {
      Row<L> v;
      if (!all_act) v.load(cur + i * L);
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (act[l]) v.v[l] = vn[l];
      v.store(nxt + i * L);
    };

    reset_parts();
    // the bulk pass over this thread's units, special rows skipped; two
    // units at a time, so one unit's loads overlap the other's chain (the
    // stride a compile-time count: as a run-time one it slowed every path
    // launch by up to 9% on an H100, PERF.md)
    int m = 0;
#pragma unroll 2
    for (int u = PATH && warp == GEN_PATCH_WARP ? n : tid; u * RPU < n; u += BULK, ++m) {
      const unsigned sb = (unsigned)(spbits >> (m * RPU)) & ((1u << RPU) - 1u);
      short ptr[RPU][L];
#pragma unroll
      for (int k = 0; k < RPU; ++k) {
        const int i = u * RPU + k;
        if (i >= n || ((sb >> k) & 1u)) continue;
        float e[L];
#pragma unroll
        for (int l = 0; l < L; ++l) e[l] = act[l] ? (kStaged ? ld(er[l] + i) : ldg(er[l] + i)) : 0.0f;
        Acc<PATH> acc[L];
        bulk(i, acc, e);
        float vn[L];
#pragma unroll
        for (int l = 0; l < L; ++l) {
          vn[l] = kShort ? acc[l].v : e[l] + acc[l].v;
          ptr[k][l] = acc[l].ptr();
        }
        put(i, vn);
        if constexpr (kCols) {
#pragma unroll
          for (int c = 0; c < C_CAP; ++c) {
            if (c < n_col) {
              const float w = cvt[c * n + i];
#pragma unroll
              for (int l = 0; l < L; ++l) cp[l * C_CAP + c].fold_up(w + vn[l], i);
            }
          }
        }
      }
      if constexpr (PATH) {
        const int i0 = u * RPU;
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (!act[l]) continue;
          short* row = a.bp + ((size_t)t * batch + b0 + l) * n;
          if ((n & 1) == 0 && sb == 0u) {
            *reinterpret_cast<short2*>(row + i0) = make_short2(ptr[0][l], ptr[1][l]);
          } else {
#pragma unroll
            for (int k = 0; k < RPU; ++k)
              if (i0 + k < n && !((sb >> k) & 1u)) row[i0 + k] = ptr[k][l];
          }
        }
      }
    }

    // the patch warp: the special rows from the previous carry, the column
    // minima of that carry merged from slot p
    if (kSpecial && warp == GEN_PATCH_WARP) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = prow[k];
        if (r < 0) continue;
        float e[L];
#pragma unroll
        for (int l = 0; l < L; ++l) e[l] = act[l] ? (kStaged ? ld(er[l] + r) : ldg(er[l] + r)) : 0.0f;
        Acc<PATH> acc[L];
        bulk(r, acc, e);
        // SHORT_CHAIN: the column and residual candidates apart, e added once
        Acc<PATH> extra[L];
#pragma unroll
        for (int l = 0; l < L; ++l) extra[l].reset();
        auto add_x = [&](int l, float c, int cs) {
          if constexpr (kShort)
            extra[l].add(c, cs);
          else
            acc[l].add(c, cs);
        };
        if constexpr (kCols) {
#pragma unroll
          for (int c = 0; c < C_CAP; ++c) {
            if (c < n_col && ((pcol[k] >> c) & 1)) {
#pragma unroll
              for (int l = 0; l < L; ++l) {
                ColPart<PATH> m_c;
                m_c.reset();
                for (int w = 0; w < GEN_WARPS; ++w) {
                  if constexpr (PATH)
                    m_c.fold(slots.v[p][w][l][c], slots.i[p][w][l][c]);
                  else
                    m_c.fold(slots.v[p][w][l][c], 0);
                }
                if constexpr (PATH)
                  add_x(l, m_c.v, m_c.i);
                else
                  add_x(l, m_c.v, 0);
              }
            }
          }
        }
        for (int z = 0; z < desc.n_res; ++z) {
          if ((pres[k] >> z) & 1) {
            const int s = desc.res_src[z];
            const float w = desc.res_val[z];
#pragma unroll
            for (int l = 0; l < L; ++l) add_x(l, w + cur[s * L + l], s);
          }
        }
        float vn[L];
#pragma unroll
        for (int l = 0; l < L; ++l)
          vn[l] = kShort ? fminf(acc[l].v, e[l] + extra[l].v) : e[l] + acc[l].v;
        put(r, vn);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          if (!act[l]) continue;
          if constexpr (PATH) a.bp[((size_t)t * batch + b0 + l) * n + r] = acc[l].ptr();
          if constexpr (kCols) {
#pragma unroll
            for (int c = 0; c < C_CAP; ++c)
              if (c < n_col) cp[l * C_CAP + c].fold(cvt[c * n + r] + vn[l], r);
          }
        }
      }
    }

    if constexpr (kCols) publish(p ^ 1, act);
    __syncthreads();
#pragma unroll
    for (int l = 0; l < L; ++l) o_cur[l] = o_next[l];
  }
  if constexpr (kStaged) asm volatile("cp.async.wait_group 0;\n" ::);

  // frozen steps store identity pointers, so a walk through a lane's
  // padding stays on its end state
  if constexpr (PATH) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (b0 + l >= batch) continue;
      for (int t = len[l]; t < steps; ++t) {
        short* row = a.bp + ((size_t)t * batch + b0 + l) * n;
        if ((n & 1) == 0) {
          for (int i = 2 * tid; i < n; i += 2 * GEN_THREADS)
            *reinterpret_cast<short2*>(row + i) = make_short2((short)i, (short)(i + 1));
        } else {
          for (int i = tid; i < n; i += GEN_THREADS) row[i] = (short)i;
        }
      }
    }
  }
  // frozen lanes were carried forward, so every lane ends in one buffer
  const float* const last = carry + (t_end & 1) * n * L;
  for (int x = tid; x < n * L; x += GEN_THREADS) {
    const int i = x / L, l = x - i * L;
    if (b0 + l < batch) a.out[(size_t)i * batch + b0 + l] = last[x];
  }
}

// ---- the launch: lanes a CTA, and whether the tables fit -----------------

// One shape of the generic template: its instantiation, lanes a CTA,
// dynamic shared memory, tables in shared memory or not.
struct GenArm {
  const void* kernel;
  int lanes;
  size_t smem;
  int staged;
};

// The instantiations of one lanes-a-CTA count: the tables in shared memory
// (smem) or in global memory (global; nullptr where the flags need them in
// shared memory).
struct GenPair {
  const void* smem;
  const void* global;
  int lanes;
};

// The shape of the generic template that a launch takes, for the operator
// `desc`, `batch` lanes and the instantiations `arms` (lanes ascending):
// the fewest lanes a CTA whose one wave holds every lane, else the most
// lanes a wave (ties: the fewer lanes a CTA). A shape whose L carries do
// not fit is out; the tables go into shared memory where they fit beside
// the carries, else they stay in global memory. Opts the shape's shared
// memory in.
static int gen_pick(const ScoresDesc* desc, int batch, const GenPair* arms, int count,
                    size_t extra_per_lane, GenArm* arm) {
  int dev = 0, sms = 0, optin = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return rc;
  const size_t n = (size_t)desc->n;
  const size_t tables = (size_t)(desc->n_diag + desc->n_row + desc->n_col) * n * sizeof(float);
  bool found = false;
  long best = -1;
  for (int k = 0; k < count; ++k) {
    cudaFuncAttributes attr;
    if ((rc = (int)cudaFuncGetAttributes(&attr, arms[k].smem))) return rc;
    const size_t room = (size_t)optin - attr.sharedSizeBytes;
    const size_t carries = (size_t)arms[k].lanes * (2 * n * sizeof(float) + extra_per_lane);
    if (carries > room) continue;
    const int staged = carries + tables <= room;
    const void* fn = staged ? arms[k].smem : arms[k].global;
    if (fn == nullptr) continue;
    const size_t smem = carries + (staged ? tables : 0);
    if ((rc = set_smem(fn, smem))) return rc;
    int ctas = 0;
    if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, GEN_THREADS, smem)))
      return rc;
    const long wave = (long)ctas * sms * arms[k].lanes;
    if (ctas == 0 || wave <= best) continue;
    *arm = {fn, arms[k].lanes, smem, staged};
    found = true;
    best = wave;
    if (wave >= batch) break;
  }
  return found ? 0 : (int)cudaErrorInvalidValue;
}

// Both instantiations of L lanes a CTA (the variants read their tables from
// shared memory only).
template <int L, int C_CAP, bool PATH, int FLAGS>
static GenPair gen_pair() {
  const void* global = nullptr;
  if constexpr (FLAGS == 0) global = (const void*)generic_kernel<L, C_CAP, PATH, FLAGS, false>;
  return {(const void*)generic_kernel<L, C_CAP, PATH, FLAGS, true>, global, L};
}

// The instantiations of the generic template for a column count: C_CAP
// bounds the dense columns whose partial minima a thread keeps in registers
// (L of each), so the more columns, the fewer lanes a CTA.
template <bool PATH, int FLAGS>
static int gen_arms(int n_col, GenPair* arms) {
  if (n_col <= 2) {
    arms[0] = gen_pair<1, 2, PATH, FLAGS>();
    arms[1] = gen_pair<2, 2, PATH, FLAGS>();
    arms[2] = gen_pair<4, 2, PATH, FLAGS>();
    return 3;
  }
  if (n_col <= 8) {
    arms[0] = gen_pair<1, 8, PATH, FLAGS>();
    arms[1] = gen_pair<2, 8, PATH, FLAGS>();
    return 2;
  }
  if constexpr (FLAGS != 0) {
    return 0;  // the variants take at most 8 dense columns
  } else {
    arms[0] = gen_pair<1, MAX_COL, PATH, FLAGS>();
    return 1;
  }
}

// The corpus model's operator shape at n states (one diagonal, one dense
// row, two dense columns): what the occupancy reports of the generic arms
// assume.
static inline ScoresDesc corpus_shaped_desc(int n) {
  ScoresDesc d = {};
  d.n = n;
  d.n_diag = 1;
  d.n_row = 1;
  d.n_col = 2;
  d.n_special = 2;
  d.diag_off[0] = 1;
  d.col_idx[0] = d.sp_row[0] = n - 2;
  d.col_idx[1] = d.sp_row[1] = n - 1;
  return d;
}

// Pick and launch the generic template: the scores arm (bp nullptr) or the
// path arm.
template <bool PATH, int FLAGS>
static int gen_launch(const ScoresDesc* desc, const GenArgs args, void* stream) {
  GenPair arms[3];
  const int count = gen_arms<PATH, FLAGS>(desc->n_col, arms);
  const size_t extra = (FLAGS & VF_EM_STAGED) ? 2 * (size_t)EM_STAGE_STEPS * desc->n * sizeof(float) : 0;
  GenArm arm;
  int rc = gen_pick(desc, args.batch, arms, count, extra, &arm);
  if (rc) return rc;
  ScoresDesc d = *desc;
  GenArgs a = args;
  void* params[] = {&d, &a};
  const int grid = (args.batch + arm.lanes - 1) / arm.lanes;
  return (int)cudaLaunchKernel(arm.kernel, dim3(grid), dim3(GEN_THREADS), params, arm.smem,
                               (cudaStream_t)stream);
}

// The shape a launch of `batch` lanes takes: lanes a CTA, threads a CTA,
// registers a thread, resident CTAs an SM, tables in shared memory.
template <bool PATH>
static int gen_shape(const ScoresDesc* desc, int batch, int* lanes_per_cta, int* threads, int* regs,
                     int* ctas_per_sm, int* staged) {
  GenPair arms[3];
  const int count = gen_arms<PATH, 0>(desc->n_col, arms);
  GenArm arm;
  int rc = gen_pick(desc, batch, arms, count, 0, &arm);
  if (rc) return rc;
  *lanes_per_cta = arm.lanes;
  *threads = GEN_THREADS;
  *staged = arm.staged;
  return occupancy_of(arm.kernel, arm.smem, regs, ctas_per_sm, GEN_THREADS);
}
