// Exact Viterbi path kernels for Hopper (sm_90a), each with a plain C entry
// point loaded through ctypes by spec_viterbi_tpu_torch/ops/fused.py.
//
//   svt_path       replaces spec_viterbi_tpu/ops/fused_pallas.py::
//                  _make_path_kernel: the scores recurrence of
//                  svt_scores_masked, tracking (value, source) pairs, and
//                  writing the winning source of every (step, lane, state)
//                  as int16 into src[T-1, B, n].
//   svt_backtrace  replaces spec_viterbi_tpu/ops/fused_pallas.py::
//                  _backtrace_kernel: the reverse walk through src from a
//                  boundary state, one thread per lane.
//
// Tie rule of svt_path, the oracle's np.argmin: a lexicographic min over
// (value, source) among finite candidates. The lowest source wins a tie, a
// tie at +inf never adopts a source, a row no finite candidate reaches
// points to 0. It is a total order, so the kernel may take the candidates
// in any order (bulk pass, per-thread partials, warp shuffles, the special
// rows' patch) and still agree with the plain version bit for bit. Values
// are exact f32 with real +inf, as in csrc/scores.cu; build without
// --use_fast_math.
//
// What bounds them on this card:
// - svt_path: like svt_scores_masked, a serial loop over T steps with two
//   block barriers and a block-wide (min, argmin) per dense column in each;
//   the latency of that chain bounds it. Its one new stream is the
//   backpointers, 2 * n bytes per lane and step (4.9 KB at n = 2,432),
//   written once and far below HBM rate at these step times. The design
//   keeps one lane's [n] carry in shared memory for the whole sequence
//   (double-buffered), stores each pointer row with coalesced 2-byte
//   stores straight from the bulk pass, and lets warp 0 rewrite the few
//   special rows after the barrier. The TPU kernel's [T, Np, B] layout
//   would stride every 2-byte store by B; here one CTA's row for one step
//   is contiguous.
// - svt_backtrace: one dependent load per step per lane (the next state is
//   the address of the next load), so latency bounds it, not bandwidth. The
//   TPU kernel picked the pointer through a one-hot min over all states
//   because a TPU has no per-lane gather; here it is one load.

#include "common.cuh"

template <int C_CAP>
__global__ void __launch_bounds__(SVT_THREADS)
path_kernel(const ScoresDesc desc, const float* __restrict__ dv, const float* __restrict__ rv,
            const float* __restrict__ cv, const float* __restrict__ em,
            const float* __restrict__ v0, const int* __restrict__ obs,
            const int* __restrict__ lengths, float* __restrict__ out, short* __restrict__ bp,
            int batch, int steps) {
  extern __shared__ float carry[];  // [2][n]
  __shared__ float red_v[SVT_WARPS][C_CAP];
  __shared__ int red_i[SVT_WARPS][C_CAP];
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
    short* bp_row = bp + ((size_t)t * batch + b) * n;
    float cval[C_CAP];
    int cidx[C_CAP];
#pragma unroll
    for (int c = 0; c < C_CAP; ++c) {
      cval[c] = INFINITY;
      cidx[c] = INT_MAX;
    }
    for (int i = tid; i < n; i += SVT_THREADS) {
      float u;
      int s;
      bulk_pair(desc, dv, rv, n, cur, n, i, u, s);
      nxt[i] = em_row[i] + u;
      bp_row[i] = (short)(u < INFINITY ? s : 0);
      const float vi = cur[i];
      // i grows along the thread's rows, so strict < keeps the lowest
      // index among equal sums
#pragma unroll
      for (int c = 0; c < C_CAP; ++c) {
        if (c < n_col) {
          const float x = cv[c * n + i] + vi;
          if (x < cval[c]) {
            cval[c] = x;
            cidx[c] = i;
          }
        }
      }
    }
    // per-column (min, argmin) across the warp, then across the warps in
    // warp 0 below
#pragma unroll
    for (int c = 0; c < C_CAP; ++c) {
      if (c < n_col) {
        float v = cval[c];
        int ix = cidx[c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, o);
          const int oi = __shfl_xor_sync(0xffffffffu, ix, o);
          pair_min(v, ix, ov, oi);
        }
        if (lane == 0) {
          red_v[warp][c] = v;
          red_i[warp][c] = ix;
        }
      }
    }
    __syncthreads();

    // warp 0 patches the special rows: dense-column targets and residual
    // destinations (the bulk pass wrote them before the barrier; these
    // writes come after it and win)
    if (warp == 0) {
      for (int sp = lane; sp < desc.n_special; sp += 32) {
        const int r = desc.sp_row[sp];
        float u;
        int s;
        bulk_pair(desc, dv, rv, n, cur, n, r, u, s);
        for (int c = 0; c < n_col; ++c) {
          if (desc.col_idx[c] != r) continue;
          float cmin = red_v[0][c];
          int carg = red_i[0][c];
          for (int w = 1; w < SVT_WARPS; ++w) pair_min(cmin, carg, red_v[w][c], red_i[w][c]);
          take(u, s, cmin, carg);
        }
        for (int z = 0; z < desc.n_res; ++z)
          if (desc.res_dst[z] == r) take(u, s, desc.res_val[z] + cur[desc.res_src[z]], desc.res_src[z]);
        nxt[r] = em_row[r] + u;
        bp_row[r] = (short)(u < INFINITY ? s : 0);
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // frozen steps keep the carry and store identity pointers, so a walk
  // through a lane's padding stays on its end state
  for (int t = my_steps; t < steps; ++t) {
    short* bp_row = bp + ((size_t)t * batch + b) * n;
    for (int i = tid; i < n; i += SVT_THREADS) bp_row[i] = (short)i;
  }
  for (int i = tid; i < n; i += SVT_THREADS) out[(size_t)i * batch + b] = cur[i];
}

// rev[t, b] = src[t, b, rev[t + 1, b]], starting from rev[steps, b] =
// boundary[b]; rev[t, b] is lane b's state at position t.
__global__ void backtrace_kernel(const short* __restrict__ src, const int* __restrict__ boundary,
                                 int* __restrict__ rev, int batch, int n, int steps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  int state = boundary[b];
  for (int t = steps - 1; t >= 0; --t) {
    state = src[((size_t)t * batch + b) * n + state];
    rev[(size_t)t * batch + b] = state;
  }
}

extern "C" {

int svt_path(const ScoresDesc* desc, const float* dv, const float* rv, const float* cv,
             const float* em, const float* v0, const int* obs, const int* lengths, float* out,
             short* bp, int batch, int steps, void* stream) {
  const size_t smem = 2 * (size_t)desc->n * sizeof(float);
  const int c = desc->n_col;
  void (*kernel)(const ScoresDesc, const float*, const float*, const float*, const float*,
                 const float*, const int*, const int*, float*, short*, int, int) =
      c <= 2 ? path_kernel<2> : c <= 8 ? path_kernel<8> : path_kernel<MAX_COL>;
  int rc = set_smem((const void*)kernel, smem);
  if (rc) return rc;
  kernel<<<batch, SVT_THREADS, smem, (cudaStream_t)stream>>>(*desc, dv, rv, cv, em, v0, obs,
                                                              lengths, out, bp, batch, steps);
  return (int)cudaGetLastError();
}

int svt_backtrace(const short* src, const int* boundary, int* rev, int batch, int n, int steps,
                  void* stream) {
  const int threads = 64;
  backtrace_kernel<<<(batch + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      src, boundary, rev, batch, n, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
