// Shared by the kernels of csrc/: block shape, descriptor caps, the
// descriptors of a structured operator (generic and planned), and the
// per-step device helpers of the scores and path kernels. ops/_build.py
// mirrors the caps, ScoresDesc and FsDesc field for field and checks the
// structs' sizes at load time.
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
// destinations) that the patch warp of csrc/generic.cuh forms.
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

// Special-row flags of the planned descriptor.
#define SP_USE_ACC 1  // start from the bulk candidate (else only the listed ones)
#define SP_SHARED 2   // row feeds the next step's shared column min

// Flags of the planned per-state byte table.
#define ST_SHARED 1   // in the shared column support
#define ST_BULK 2     // shared and not special: reduced inside the bulk pass
#define ST_SPECIAL 4  // a special row (svt_scores_fs forms it in its bulk pass)
#define ST_USE_ACC 8  // a special row that starts from the bulk candidate

// One operator of the uniform plans (single diagonal d, uniform dense rows
// as scalar candidates, the dense columns as one shared min plus scalar
// fixes), flattened by ops/fused.py FsTables: every special row (column
// target, row-plan fix, recomputed row) takes the min of the bulk
// candidate (SP_USE_ACC), its scalar candidates cand_* in
// [sp_begin[s], sp_begin[s+1]) and sp_rmin_base[s] + the shared min. The
// fields after cand_val serve the path kernel: n_real bounds the uniform
// candidate to the real states (a padding row then points to 0, as the
// generic step has it), col_base[c] is dense column c's base and sp_col[s]
// the column whose target special row s is (-1 for none).
struct FsDesc {
  int n, d, n_uni, n_special;
  int uni_src[MAX_UNI];
  float uni_val[MAX_UNI];
  int sp_row[MAX_SPECIAL];
  int sp_flags[MAX_SPECIAL];
  float sp_rmin_base[MAX_SPECIAL];  // +inf where the row has no column plan entry
  int sp_begin[MAX_SPECIAL + 1];    // candidate range of each special row
  int cand_src[MAX_CANDS];
  float cand_val[MAX_CANDS];
  int n_real, n_col;
  float col_base[MAX_COL];
  int sp_col[MAX_SPECIAL];
};

// Dynamic shared memory above 48 KB must be opted into per kernel.
static inline int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Registers a thread and resident CTAs an SM of kernel `fn` with `smem`
// bytes of dynamic shared memory and CTAs of `threads`, as the card
// reports them.
static inline int occupancy_of(const void* fn, size_t smem, int* regs, int* ctas_per_sm,
                               int threads = SVT_THREADS) {
  int rc = set_smem(fn, smem);
  if (rc) return rc;
  cudaFuncAttributes attr;
  rc = (int)cudaFuncGetAttributes(&attr, fn);
  if (rc) return rc;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, threads, smem);
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

// An upper bound of ulp(x) for any float x: |x| * 2^-23 rounded up for a
// normal x (whose ulp is 2^(e-23) with 2^e <= |x|), 2^-149 for a subnormal
// or zero, +inf for an infinite x.
__device__ __forceinline__ float ulp_bound(float x) {
  return fmaxf(__fmul_ru(fabsf(x), 0x1p-23f), 0x1p-149f);
}

// An operand value as f32: f32 tables as they are, bf16 tables (the
// bf16_ops variant of the generic scores arm) upcast exactly.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

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
