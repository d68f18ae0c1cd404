// Whole-sequence structured Viterbi scores kernels for Hopper (sm_90a).
//
// Two kernels, each with a plain C entry point loaded through ctypes by
// spec_viterbi_tpu_torch/ops/fused.py (built by ops/_build.py):
//
//   svt_scores_masked  replaces spec_viterbi_tpu/ops/fused_pallas.py::
//                      _make_unrolled_kernel (masked, any fused-eligible
//                      operator: diagonals, dense rows, dense columns and
//                      at most MAX_RES residual entries).
//   svt_scores_fs      replaces spec_viterbi_tpu/ops/fused_pallas.py::
//                      _make_fs_kernel (unmasked; one diagonal, uniform
//                      dense rows, one shared column reduce plus scalar
//                      fixes).
//
// Recurrence per lane b, in -log2 space with +inf as the semiring zero:
//   v'[i] = em[o_t][i] + min(candidates of row i),
// every candidate one f32 add, rounded once, and min exact, so the result
// is bit-equal to the numpy oracle and to the plain PyTorch versions.
// Build without --use_fast_math: flush-to-zero or approximate adds would
// break that.
//
// What bounds them: a serial loop over T steps, each ending in block-wide
// barriers and a min-reduction; the bytes per step are small (one f32
// emission row of n floats, read from L2). So the cost is the latency of
// the per-step barrier and reduction, not bandwidth. The design keeps the
// whole [n] carry of one lane in shared memory for the whole sequence
// (double-buffered, 2 * n * 4 bytes), makes one pass over the states per
// step, and lets one warp patch the few special rows after the pass.
// One CTA owns one lane, so a lane that is done stops (the masked
// kernel's per-lane freeze) and lanes never wait for each other.

#include "common.cuh"

// Special-row flags of the FS descriptor.
#define SP_USE_ACC 1  // start from the bulk candidate (else only the listed ones)
#define SP_SHARED 2   // row feeds the next step's shared column min

// Flags of the FS per-state byte table.
#define ST_SHARED 1   // in the shared column support
#define ST_BULK 2     // shared and not special: reduced inside the bulk pass

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
};

// C_CAP bounds the dense columns whose partial mins each thread keeps in
// registers; the entry point picks the smallest instantiation that fits.
template <int C_CAP>
__global__ void __launch_bounds__(SVT_THREADS)
scores_masked_kernel(const ScoresDesc desc, const float* __restrict__ dv,
                     const float* __restrict__ rv, const float* __restrict__ cv,
                     const float* __restrict__ em, const float* __restrict__ v0,
                     const int* __restrict__ obs, const int* __restrict__ lengths,
                     float* __restrict__ out, int batch, int steps) {
  extern __shared__ float carry[];  // [2][n]
  __shared__ float red[SVT_WARPS][C_CAP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int n = desc.n, n_col = desc.n_col;
  for (int i = tid; i < n; i += SVT_THREADS) carry[i] = v0[(size_t)i * batch + b];
  const int my_steps = lane_steps(lengths, b, steps);
  __syncthreads();

  float* cur = carry;
  float* nxt = carry + n;
  for (int t = 0; t < my_steps; ++t) {
    const float* em_row = em + (size_t)obs[(size_t)t * batch + b] * n;
    float cpart[C_CAP];
#pragma unroll
    for (int c = 0; c < C_CAP; ++c) cpart[c] = INFINITY;
    for (int i = tid; i < n; i += SVT_THREADS) {
      nxt[i] = em_row[i] + bulk_candidate(desc, dv, rv, n, cur, n, i);
      const float vi = cur[i];
#pragma unroll
      for (int c = 0; c < C_CAP; ++c)
        if (c < n_col) cpart[c] = fminf(cpart[c], cv[c * n + i] + vi);
    }
#pragma unroll
    for (int c = 0; c < C_CAP; ++c) {
      if (c < n_col) {
        const float m = warp_min(cpart[c]);
        if (lane == 0) red[warp][c] = m;
      }
    }
    __syncthreads();

    // one warp patches the special rows: dense-column targets and
    // residual destinations
    if (warp == 0) {
      for (int s = lane; s < desc.n_special; s += 32) {
        const int r = desc.sp_row[s];
        float a = bulk_candidate(desc, dv, rv, n, cur, n, r);
        for (int c = 0; c < n_col; ++c) {
          if (desc.col_idx[c] != r) continue;
          for (int w = 0; w < SVT_WARPS; ++w) a = fminf(a, red[w][c]);
        }
        for (int z = 0; z < desc.n_res; ++z)
          if (desc.res_dst[z] == r) a = fminf(a, desc.res_val[z] + cur[desc.res_src[z]]);
        nxt[r] = em_row[r] + a;
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int i = tid; i < n; i += SVT_THREADS) out[(size_t)i * batch + b] = cur[i];
}

__global__ void __launch_bounds__(SVT_THREADS)
scores_fs_kernel(const FsDesc desc, const float* __restrict__ dv,
                 const unsigned char* __restrict__ flags, const float* __restrict__ em,
                 const float* __restrict__ v0, const int* __restrict__ obs,
                 float* __restrict__ out, int batch, int steps) {
  extern __shared__ float carry[];  // [2][n]
  __shared__ float red[SVT_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int n = desc.n, d = desc.d;

  // the shared column min of the incoming carry seeds the first step
  float part = INFINITY;
  for (int i = tid; i < n; i += SVT_THREADS) {
    const float v = v0[(size_t)i * batch + b];
    carry[i] = v;
    if (flags[i] & ST_SHARED) part = fminf(part, v);
  }
  part = warp_min(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  float r_min = INFINITY;  // lives in warp 0, the only reader
  if (warp == 0) r_min = warp_min(lane < SVT_WARPS ? red[lane] : INFINITY);
  __syncthreads();

  float* cur = carry;
  float* nxt = carry + n;
  for (int t = 0; t < steps; ++t) {
    const float* em_row = em + (size_t)obs[(size_t)t * batch + b] * n;
    // uniform dense rows: one scalar candidate shared by every row
    float ub = INFINITY;
    for (int u = 0; u < desc.n_uni; ++u) ub = fminf(ub, desc.uni_val[u] + cur[desc.uni_src[u]]);

    // bulk pass; the next step's shared column min is taken from v_new
    // while it is still in a register
    part = INFINITY;
    for (int i = tid; i < n; i += SVT_THREADS) {
      const int j = i - d;
      const float a = fminf((j >= 0 && j < n) ? dv[i] + cur[j] : INFINITY, ub);
      const float vn = em_row[i] + a;
      nxt[i] = vn;
      if (flags[i] & ST_BULK) part = fminf(part, vn);
    }
    part = warp_min(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();

    if (warp == 0) {
      float r_next = lane < SVT_WARPS ? red[lane] : INFINITY;
      for (int s = lane; s < desc.n_special; s += 32) {
        const int r = desc.sp_row[s];
        const int f = desc.sp_flags[s];
        float p = INFINITY;
        if (f & SP_USE_ACC) {
          const int j = r - d;
          p = fminf((j >= 0 && j < n) ? dv[r] + cur[j] : INFINITY, ub);
        }
        for (int c = desc.sp_begin[s]; c < desc.sp_begin[s + 1]; ++c)
          p = fminf(p, desc.cand_val[c] + cur[desc.cand_src[c]]);
        p = fminf(p, desc.sp_rmin_base[s] + r_min);
        const float val = em_row[r] + p;
        nxt[r] = val;
        if (f & SP_SHARED) r_next = fminf(r_next, val);
      }
      r_min = warp_min(r_next);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int i = tid; i < n; i += SVT_THREADS) out[(size_t)i * batch + b] = cur[i];
}

extern "C" {

int svt_desc_size(int which) {
  return which == 0 ? (int)sizeof(ScoresDesc) : (int)sizeof(FsDesc);
}

const char* svt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int svt_scores_masked(const ScoresDesc* desc, const float* dv, const float* rv, const float* cv,
                      const float* em, const float* v0, const int* obs, const int* lengths,
                      float* out, int batch, int steps, void* stream) {
  const size_t smem = 2 * (size_t)desc->n * sizeof(float);
  const int c = desc->n_col;
  void (*kernel)(const ScoresDesc, const float*, const float*, const float*, const float*,
                 const float*, const int*, const int*, float*, int, int) =
      c <= 2 ? scores_masked_kernel<2> : c <= 8 ? scores_masked_kernel<8> : scores_masked_kernel<MAX_COL>;
  int rc = set_smem((const void*)kernel, smem);
  if (rc) return rc;
  kernel<<<batch, SVT_THREADS, smem, (cudaStream_t)stream>>>(*desc, dv, rv, cv, em, v0, obs,
                                                              lengths, out, batch, steps);
  return (int)cudaGetLastError();
}

int svt_scores_fs(const FsDesc* desc, const float* dv, const unsigned char* flags,
                  const float* em, const float* v0, const int* obs, float* out, int batch,
                  int steps, void* stream) {
  const size_t smem = 2 * (size_t)desc->n * sizeof(float);
  int rc = set_smem((const void*)scores_fs_kernel, smem);
  if (rc) return rc;
  scores_fs_kernel<<<batch, SVT_THREADS, smem, (cudaStream_t)stream>>>(
      *desc, dv, flags, em, v0, obs, out, batch, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
