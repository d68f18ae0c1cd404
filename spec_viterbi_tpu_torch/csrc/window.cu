// Window kernels of the chunked-halo state-sharded decode for Hopper
// (sm_90a), each with a plain C entry point loaded through ctypes by
// spec_viterbi_tpu_torch/parallel/fused_tp.py.
//
//   svt_scores_window  replaces spec_viterbi_tpu/parallel/fused_tp.py::
//                      FusedTPDecoder._pallas_win: c masked steps of the
//                      scores recurrence (svt_scores_masked's) on the
//                      state window of each shard of a banded operator.
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
// window gives no candidate (the bounds check of bulk_candidate), so
// window edges become +inf where the TPU kernel's cyclic roll brought in
// garbage; either way only halo rows see it, and they are exchanged anew.
//
// Grid (B, S): CTA (b, s) runs lane b of the s-th window of the launch.
// Carry rows of window s start at row s*block of v_in and v_out, operand
// rows at op_row0 + s*block of dv [D][stride] and em [E][stride]:
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
// What bounds them: as the whole-operator kernels, the latency of the
// per-step chain (a pass over the window and a block barrier), not bytes:
// one emission row of n_win floats and, for paths, one pointer row of
// `block` int16 per lane and step. A window is small (n_win = 656 at 2,432
// states and 4 shards: 5.2 KB of double-buffered carry in shared memory),
// so the design runs one CTA per (lane, shard), B*K CTAs per launch, with
// a single barrier per step (no special rows to patch).

#include "common.cuh"

__global__ void __launch_bounds__(SVT_THREADS)
scores_window_kernel(const ScoresDesc desc, const float* __restrict__ dv,
                     const float* __restrict__ em, int stride, int op_row0, int block, int h_lo,
                     const float* __restrict__ v_in, const int* __restrict__ obs,
                     const int* __restrict__ lengths, float* __restrict__ v_out, int batch,
                     int steps) {
  extern __shared__ float carry[];  // [2][n_win]
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int n = desc.n;  // n_win
  const size_t row0 = (size_t)blockIdx.y * block;
  const float* dv_w = dv + op_row0 + row0;
  const float* em_w = em + op_row0 + row0;
  for (int i = tid; i < n; i += SVT_THREADS) carry[i] = v_in[(row0 + i) * batch + b];
  const int my_steps = lane_steps(lengths, b, steps);
  __syncthreads();

  float* cur = carry;
  float* nxt = carry + n;
  for (int t = 0; t < my_steps; ++t) {
    const float* em_row = em_w + (size_t)obs[(size_t)t * batch + b] * stride;
    for (int i = tid; i < n; i += SVT_THREADS)
      nxt[i] = em_row[i] + bulk_candidate(desc, dv_w, (const float*)nullptr, stride, cur, n, i);
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int i = h_lo + tid; i < h_lo + block; i += SVT_THREADS)
    v_out[(row0 + i) * batch + b] = cur[i];
}

__global__ void __launch_bounds__(SVT_THREADS)
path_window_kernel(const ScoresDesc desc, const float* __restrict__ dv,
                   const float* __restrict__ em, int stride, int op_row0, int block, int h_lo,
                   const float* __restrict__ v_in, const int* __restrict__ obs,
                   const int* __restrict__ lengths, float* __restrict__ v_out,
                   short* __restrict__ bp, int bp_width, int ptr_base, int batch, int steps) {
  extern __shared__ float carry[];  // [2][n_win]
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int n = desc.n;  // n_win
  const size_t row0 = (size_t)blockIdx.y * block;
  const int base = ptr_base + (int)blockIdx.y * block;
  const float* dv_w = dv + op_row0 + row0;
  const float* em_w = em + op_row0 + row0;
  for (int i = tid; i < n; i += SVT_THREADS) carry[i] = v_in[(row0 + i) * batch + b];
  const int my_steps = lane_steps(lengths, b, steps);
  __syncthreads();

  float* cur = carry;
  float* nxt = carry + n;
  for (int t = 0; t < my_steps; ++t) {
    const float* em_row = em_w + (size_t)obs[(size_t)t * batch + b] * stride;
    short* bp_row = bp + ((size_t)t * batch + b) * bp_width + row0;  // interior row k = i - h_lo
    for (int i = tid; i < n; i += SVT_THREADS) {
      float u;
      int s;
      bulk_pair(desc, dv_w, nullptr, stride, cur, n, i, u, s);
      nxt[i] = em_row[i] + u;
      const int k = i - h_lo;
      if (k >= 0 && k < block) bp_row[k] = (short)(u < INFINITY ? s + base : 0);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // frozen steps keep the carry and store identity pointers
  for (int t = my_steps; t < steps; ++t) {
    short* bp_row = bp + ((size_t)t * batch + b) * bp_width + row0;
    for (int k = tid; k < block; k += SVT_THREADS) bp_row[k] = (short)(k + h_lo + base);
  }
  for (int i = h_lo + tid; i < h_lo + block; i += SVT_THREADS)
    v_out[(row0 + i) * batch + b] = cur[i];
}

extern "C" {

int svt_scores_window(const ScoresDesc* desc, const float* dv, const float* em, int stride,
                      int op_row0, int block, int h_lo, const float* v_in, const int* obs,
                      const int* lengths, float* v_out, int batch, int shards, int steps,
                      void* stream) {
  const size_t smem = 2 * (size_t)desc->n * sizeof(float);
  int rc = set_smem((const void*)scores_window_kernel, smem);
  if (rc) return rc;
  scores_window_kernel<<<dim3(batch, shards), SVT_THREADS, smem, (cudaStream_t)stream>>>(
      *desc, dv, em, stride, op_row0, block, h_lo, v_in, obs, lengths, v_out, batch, steps);
  return (int)cudaGetLastError();
}

int svt_path_window(const ScoresDesc* desc, const float* dv, const float* em, int stride,
                    int op_row0, int block, int h_lo, const float* v_in, const int* obs,
                    const int* lengths, float* v_out, short* bp, int bp_width, int ptr_base,
                    int batch, int shards, int steps, void* stream) {
  const size_t smem = 2 * (size_t)desc->n * sizeof(float);
  int rc = set_smem((const void*)path_window_kernel, smem);
  if (rc) return rc;
  path_window_kernel<<<dim3(batch, shards), SVT_THREADS, smem, (cudaStream_t)stream>>>(
      *desc, dv, em, stride, op_row0, block, h_lo, v_in, obs, lengths, v_out, bp, bp_width,
      ptr_base, batch, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
