// Shared by the kernels of csrc/: block shape, descriptor caps, the
// descriptor of a structured operator, and the per-step device helpers of
// the scores and path kernels. ops/_build.py mirrors the caps and
// ScoresDesc field for field and checks the struct's size at load time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <climits>

#define SVT_THREADS 256
#define SVT_WARPS (SVT_THREADS / 32)

// Caps of the descriptors; fused_eligible() keeps D + R + C + Z <= 24 and
// Z <= 8, the uniform plans keep their fixes within MAX_COL_EXTRAS = 8.
#define MAX_DIAG 8
#define MAX_ROW 24
#define MAX_COL 24
#define MAX_RES 8
#define MAX_SPECIAL 40
#define MAX_UNI 24
#define MAX_CANDS 216

// One structured operator: diagonals, dense rows, dense columns, residual
// entries; sp_row lists the special rows (column targets and residual
// destinations) that one warp patches after the bulk pass.
struct ScoresDesc {
  int n, n_diag, n_row, n_col, n_res, n_special;
  int diag_off[MAX_DIAG];
  int row_idx[MAX_ROW];
  int col_idx[MAX_COL];
  int res_src[MAX_RES];
  int res_dst[MAX_RES];
  float res_val[MAX_RES];
  int sp_row[MAX_SPECIAL];
};

// Dynamic shared memory above 48 KB must be opted into per kernel.
static inline int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Steps lane b takes out of `steps`: it freezes once step t+1 reaches its
// length (all steps when there are no lengths).
__device__ __forceinline__ int lane_steps(const int* __restrict__ lengths, int b, int steps) {
  if (lengths == nullptr) return steps;
  const int l = lengths[b] - 1;
  return l < 0 ? 0 : (l < steps ? l : steps);
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// An operand value as f32: f32 tables as they are, bf16 tables (the
// bf16_ops variant of the masked scores kernel) upcast exactly.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// min over the diagonal and dense-row candidates of row i of an n-row
// carry. The value arrays dv [D][stride] and rv [R][stride] hold row i at
// column i: stride is n for a whole operator and the padded global state
// count for a window (csrc/window.cu). A source outside [0, n) gives no
// candidate. The descriptor is read from the kernel parameter (the
// constant bank): a copy in shared memory could alias the carry, and the
// compiler would then reload it for every state. FOLD (the short_chain
// variant of the masked scores kernel) adds the emission e to each value
// before the carry, (e + w) + cur[j], so the step rounds twice.
template <bool FOLD = false, typename T>
__device__ __forceinline__ float bulk_candidate(const ScoresDesc& desc, const T* __restrict__ dv,
                                                const T* __restrict__ rv, int stride,
                                                const float* cur, int n, int i, float e = 0.0f) {
  float a = INFINITY;
  for (int q = 0; q < desc.n_diag; ++q) {
    const int j = i - desc.diag_off[q];
    if (j >= 0 && j < n) {
      const float w = ld(dv + (size_t)q * stride + i);
      a = fminf(a, (FOLD ? e + w : w) + cur[j]);
    }
  }
  for (int r = 0; r < desc.n_row; ++r) {
    const float w = ld(rv + (size_t)r * stride + i);
    a = fminf(a, (FOLD ? e + w : w) + cur[desc.row_idx[r]]);
  }
  return a;
}

// The tie rule of the path kernels, the oracle's np.argmin: a
// lexicographic min over (value, source) among finite candidates. The
// lowest source wins a tie, a tie at +inf never adopts a source, a row no
// finite candidate reaches points to 0. It is a total order, so candidates
// may be taken in any order.
//
// Adopt candidate (c, cs) if it precedes (u, s) under the tie rule.
__device__ __forceinline__ void take(float& u, int& s, float c, int cs) {
  if (c < u || (c == u && cs < s && c < INFINITY)) {
    u = c;
    s = cs;
  }
}

// (value, index) lexicographic min without the finiteness guard: used
// inside one dense column's argmin, whose +inf result is never adopted.
//
// The values are compared as floats, never as raw bits. A p = 1 transition
// costs -0.0 (to_modified_prob_np), and -0.0 == +0.0 must tie and resolve
// by index. Packing a raw float and an index into one integer key would
// order the -0.0 bit pattern above +inf; a packed key needs the float
// canonicalised first (x + 0.0f turns -0.0 into +0.0).
__device__ __forceinline__ void pair_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// (value, source) of row i over the diagonal and dense-row candidates;
// strides and bounds as in bulk_candidate. Sources are carry rows.
__device__ __forceinline__ void bulk_pair(const ScoresDesc& desc, const float* __restrict__ dv,
                                          const float* __restrict__ rv, int stride,
                                          const float* cur, int n, int i, float& u, int& s) {
  u = INFINITY;
  s = INT_MAX;
  for (int q = 0; q < desc.n_diag; ++q) {
    const int j = i - desc.diag_off[q];
    if (j >= 0 && j < n) take(u, s, dv[(size_t)q * stride + i] + cur[j], j);
  }
  for (int r = 0; r < desc.n_row; ++r) {
    const int k = desc.row_idx[r];
    take(u, s, rv[(size_t)r * stride + i] + cur[k], k);
  }
}
