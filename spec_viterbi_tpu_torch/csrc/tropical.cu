// The dense (min,+) product for Hopper (sm_90a): svt_minplus.
//
//   C[g, i, j] = min_k A_g[i, k] + B[g, k, j]
//
// with A_g = A[a_idx[g]] when an index vector is given, else A[g] (one
// shared A when its stride_g is 0). A is read through the strides it is
// given (stride_g, stride_i, stride_k), so both layouts of the decoder need
// no transpose: the untransposed transition matrix of the batched TN step
// (stride_i = 1) and the row-major operators of the matvec and of the
// specializer (stride_k = 1). B and C are contiguous [G, K, J] and
// [G, I, J]. An optional int32 argmin[g, i, j] takes the lowest k among the
// minima (strict < in k order; a tie between infinities never adopts a k,
// and a row that is all +inf points to 0), the numpy oracle's argmin.
//
// What it replaces: spec_viterbi_tpu/ops/tropical.py:89
// (tropical_mm_tn_blocked, the dense batch step and add_level) and :31-43
// (tropical_mv and tropical_mv_argmin, the matvec steps). These are XLA
// broadcast+reduce expressions; the JAX package has no Pallas kernel for
// them. The analog of cuASR's Srgemm<minimum, plus>.
//
// What bounds it: operations, for J > 1. Every candidate costs an f32 add
// and a min (2 I K J a product), and (min,+) has no tensor-core
// instruction, so the FP32 lanes set the pace (33.45 T such operations a
// second on an H100 SXM, probes/bounds.py); a batch step of 2,432 states by
// 56 lanes needs 0.66 G of them against 24 MB of operands. The design
// keeps each candidate out of device memory: a tile of A and of B is
// staged in shared memory, and each thread keeps TM x TN running minima in
// registers, so a k step costs a thread TM + TN shared loads for 2 TM TN
// operations. Rows and columns of a thread are strided by the thread grid,
// so a warp's shared reads and its stores of C are on consecutive
// addresses. Few lanes give few output tiles (38 of 64 x 64 at 2,432 x 56
// for 132 SMs), so K is split over CTAs until about four CTAs an SM are in
// flight; each split writes its minima (and argmins) to a workspace the
// wrapper allocates, and a second launch merges the splits in k order,
// keeping the lower k on equal values. J <= 16 takes a 64 x 16 tile. J = 1
// (a matvec: bytes-bound, one read of A) has an arm of its own: a warp a
// row, its lanes reading consecutive k (coalesced for row-major A), a
// shuffle reduce keeping the lower k on equal values.
//
// Exact f32: every candidate is rounded once, the min is exact, +inf is
// real (no finite stand-in), so the result does not depend on the order in
// which k is taken and is bit-equal to the plain PyTorch version. Offsets
// are 64-bit: a level-2 stack at 2,432 states holds 2.6e9 elements.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MP_BK = 16;        // k a shared-memory stage
constexpr int MP_ROW_WARPS = 8;  // rows (warps) a CTA of the J = 1 arm
constexpr int MP_MAX_GRID = 65535;
constexpr int MP_CTAS_PER_SM = 4;     // the split's target
constexpr int MP_MIN_SPLIT_K = 4 * MP_BK;  // k a split takes at least

template <int BM, int BN, int TM, int TN, bool A_I_CONTIG, bool ARGMIN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
minplus_tiled(const float* __restrict__ a, const long long* __restrict__ a_idx,
              const float* __restrict__ b, float* __restrict__ c, int* __restrict__ arg,
              long long sa_g, long long sa_i, long long sa_k, int G, int I, int K, int J,
              int tiles_j, int k_split) {
  constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  // +1: the k-fastest fill of the row-major layout hits distinct banks
  __shared__ float as[MP_BK][BM + 1];
  __shared__ float bs[MP_BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int split = blockIdx.x / tiles_j;
  const int i0 = blockIdx.y * BM, j0 = (blockIdx.x % tiles_j) * BN;
  const int k_lo = split * k_split, k_hi = min(K, k_lo + k_split);
  // a split's minima go to its slice of the workspace
  c += split * (long long)G * I * J;
  if (ARGMIN) arg += split * (long long)G * I * J;
  for (long long g = blockIdx.z; g < G; g += gridDim.z) {
    const float* ag = a + (a_idx ? a_idx[g] : g) * sa_g;
    const float* bg = b + g * K * (long long)J;
    float acc[TM][TN];
    int idx[TM][TN];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        acc[m][n] = INFINITY;
        idx[m][n] = 0;
      }
    for (int k0 = k_lo; k0 < k_hi; k0 += MP_BK) {
      for (int e = tid; e < BM * MP_BK; e += THREADS) {
        // consecutive threads on A's contiguous dimension
        const int ii = A_I_CONTIG ? e % BM : e / MP_BK;
        const int kk = A_I_CONTIG ? e / BM : e % MP_BK;
        const int gi = i0 + ii, gk = k0 + kk;
        as[kk][ii] = (gi < I && gk < k_hi) ? __ldg(ag + gi * sa_i + gk * sa_k) : INFINITY;
      }
      for (int e = tid; e < MP_BK * BN; e += THREADS) {
        const int kk = e / BN, jj = e % BN;
        const int gk = k0 + kk, gj = j0 + jj;
        bs[kk][jj] = (gk < k_hi && gj < J) ? __ldg(bg + (long long)gk * J + gj) : INFINITY;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < MP_BK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) av[m] = as[kk][ty + m * TY];
#pragma unroll
        for (int n = 0; n < TN; ++n) bv[n] = bs[kk][tx + n * TX];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const float s = av[m] + bv[n];
            if (ARGMIN) {
              if (s < acc[m][n]) {
                acc[m][n] = s;
                idx[m][n] = k0 + kk;
              }
            } else {
              acc[m][n] = fminf(acc[m][n], s);
            }
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int gi = i0 + ty + m * TY;
      if (gi >= I) continue;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int gj = j0 + tx + n * TX;
        if (gj >= J) continue;
        const long long o = (g * I + gi) * (long long)J + gj;
        c[o] = acc[m][n];
        if (ARGMIN) arg[o] = idx[m][n];
      }
    }
  }
}

// The splits' minima, merged in k order: a later split replaces only a
// strictly lower value, so the lowest k wins a tie (an all-inf output
// keeps split 0's k = 0).
template <bool ARGMIN>
__global__ void minplus_merge(const float* __restrict__ ws, const int* __restrict__ ws_arg,
                              float* __restrict__ c, int* __restrict__ arg, long long outputs,
                              int splits) {
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < outputs;
       o += (long long)gridDim.x * blockDim.x) {
    float best = ws[o];
    int bi = ARGMIN ? ws_arg[o] : 0;
    for (int s = 1; s < splits; ++s) {
      const float v = ws[s * outputs + o];
      if (ARGMIN) {
        if (v < best) {
          best = v;
          bi = ws_arg[s * outputs + o];
        }
      } else {
        best = fminf(best, v);
      }
    }
    c[o] = best;
    if (ARGMIN) arg[o] = bi;
  }
}

// J = 1: a warp a row of A_g, each lane taking k = lane, lane + 32, ...
template <bool ARGMIN>
__global__ void __launch_bounds__(MP_ROW_WARPS * 32)
minplus_rows(const float* __restrict__ a, const long long* __restrict__ a_idx,
             const float* __restrict__ b, float* __restrict__ c, int* __restrict__ arg,
             long long sa_g, long long sa_i, long long sa_k, int G, int I, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * MP_ROW_WARPS + threadIdx.x / 32;
  if (row >= I) return;  // the whole warp: no barrier below
  for (long long g = blockIdx.y; g < G; g += gridDim.y) {
    const float* ar = a + (a_idx ? a_idx[g] : g) * sa_g + row * sa_i;
    const float* bg = b + g * K;
    float best = INFINITY;
    int bi = 0;
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float s = __ldg(ar + k * sa_k) + __ldg(bg + k);
      if (ARGMIN) {
        if (s < best) {
          best = s;
          bi = k;
        }
      } else {
        best = fminf(best, s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, off);
      if (ARGMIN) {
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        // the lower k on equal values: lane-local k ascend, so this keeps
        // the lowest k of the row (an all-inf lane holds k = 0)
        if (ob < best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      } else {
        best = fminf(best, ob);
      }
    }
    if (lane == 0) {
      c[g * I + row] = best;
      if (ARGMIN) arg[g * I + row] = bi;
    }
  }
}

struct MpShape {
  int bm, bn, threads, splits, k_split, tiles_j;
  dim3 grid;
};

// J = 1 takes the row arm; J <= 16 a 64 x 16 tile, else 64 x 64; K splits
// over CTAs until about MP_CTAS_PER_SM CTAs an SM are in flight, each split
// at least MP_MIN_SPLIT_K deep.
int minplus_shape(int g, int i, int k, int j, MpShape* s) {
  const int gz = g < MP_MAX_GRID ? g : MP_MAX_GRID;
  if (j == 1) {
    *s = {1, 1, MP_ROW_WARPS * 32, 1, k, 1,
          dim3((i + MP_ROW_WARPS - 1) / MP_ROW_WARPS, gz)};
    return 0;
  }
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc) return rc;
  const int bm = 64, bn = j <= 16 ? 16 : 64;
  const int threads = bn == 64 ? 256 : 128;
  const int tiles_i = (i + bm - 1) / bm, tiles_j = (j + bn - 1) / bn;
  if (tiles_i > MP_MAX_GRID) return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)tiles_i * tiles_j * g;
  const long long want = (long long)MP_CTAS_PER_SM * sms;
  const long long max_splits = k > MP_MIN_SPLIT_K ? (k + MP_MIN_SPLIT_K - 1) / MP_MIN_SPLIT_K : 1;
  int splits = (int)((want + ctas - 1) / ctas);
  if (splits > max_splits) splits = (int)max_splits;
  if (splits < 1) splits = 1;
  // stages align: a split covers a whole number of MP_BK
  int k_split = (k + splits - 1) / splits;
  k_split = (k_split + MP_BK - 1) / MP_BK * MP_BK;
  if (k_split < MP_BK) k_split = MP_BK;
  splits = (k + k_split - 1) / k_split;
  if (splits < 1) splits = 1;
  if ((long long)tiles_j * splits > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *s = {bm, bn, threads, splits, k_split, tiles_j, dim3(tiles_j * splits, tiles_i, gz)};
  return 0;
}

template <int BN, int TN, bool ARGMIN>
void launch_tiled(const MpShape& s, bool i_contig, cudaStream_t stream, const float* a,
                  const long long* a_idx, const float* b, float* c, int* arg, long long sa_g,
                  long long sa_i, long long sa_k, int g, int i, int k, int j) {
  if (i_contig)
    minplus_tiled<64, BN, 4, TN, true, ARGMIN><<<s.grid, s.threads, 0, stream>>>(
        a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, s.tiles_j, s.k_split);
  else
    minplus_tiled<64, BN, 4, TN, false, ARGMIN><<<s.grid, s.threads, 0, stream>>>(
        a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, s.tiles_j, s.k_split);
}

}  // namespace

extern "C" {

// argmin (nullptr: none) and a_idx (nullptr: A_g = A[g]) are optional.
// The caller allocates c and argmin, [g, i, j] each, and, where
// svt_minplus_shape gives splits > 1, the workspace: ws [splits, g, i, j]
// f32 and, with argmin, ws_arg the same in int32 (else both may be null).
int svt_minplus(const float* a, const long long* a_idx, const float* b, float* c, int* argmin,
                long long sa_g, long long sa_i, long long sa_k, int g, int i, int k, int j,
                float* ws, int* ws_arg, void* stream) {
  if (g <= 0 || i <= 0 || j <= 0) return 0;
  MpShape s;
  int rc = minplus_shape(g, i, k, j, &s);
  if (rc) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  if (j == 1) {
    if (argmin)
      minplus_rows<true><<<s.grid, s.threads, 0, st>>>(a, a_idx, b, c, argmin, sa_g, sa_i, sa_k, g, i, k);
    else
      minplus_rows<false><<<s.grid, s.threads, 0, st>>>(a, a_idx, b, c, argmin, sa_g, sa_i, sa_k, g, i, k);
    return (int)cudaGetLastError();
  }
  if (s.splits > 1 && (!ws || (argmin && !ws_arg))) return (int)cudaErrorInvalidValue;
  float* out = s.splits > 1 ? ws : c;
  int* out_arg = s.splits > 1 ? ws_arg : argmin;
  const bool i_contig = sa_i == 1 && sa_k != 1;
  if (s.bn == 64) {
    if (argmin)
      launch_tiled<64, 4, true>(s, i_contig, st, a, a_idx, b, out, out_arg, sa_g, sa_i, sa_k, g, i, k, j);
    else
      launch_tiled<64, 4, false>(s, i_contig, st, a, a_idx, b, out, out_arg, sa_g, sa_i, sa_k, g, i, k, j);
  } else {
    if (argmin)
      launch_tiled<16, 2, true>(s, i_contig, st, a, a_idx, b, out, out_arg, sa_g, sa_i, sa_k, g, i, k, j);
    else
      launch_tiled<16, 2, false>(s, i_contig, st, a, a_idx, b, out, out_arg, sa_g, sa_i, sa_k, g, i, k, j);
  }
  rc = (int)cudaGetLastError();
  if (rc || s.splits == 1) return rc;
  const long long outputs = (long long)g * i * j;
  const long long blocks = (outputs + 255) / 256;
  const unsigned grid = (unsigned)(blocks < 4096 ? blocks : 4096);
  if (argmin)
    minplus_merge<true><<<grid, 256, 0, st>>>(ws, ws_arg, c, argmin, outputs, s.splits);
  else
    minplus_merge<false><<<grid, 256, 0, st>>>(ws, ws_arg, c, argmin, outputs, s.splits);
  return (int)cudaGetLastError();
}

// The shape svt_minplus launches for a [g, i, j] output over k: tile rows
// and columns (1 x 1: the row arm), threads a CTA, CTAs in all, and the
// splits of K (their workspace is the caller's).
int svt_minplus_shape(int g, int i, int k, int j, int* bm, int* bn, int* threads, long long* ctas,
                      int* splits) {
  MpShape s;
  int rc = minplus_shape(g, i, k, j, &s);
  if (rc) return rc;
  *bm = s.bm;
  *bn = s.bn;
  *threads = s.threads;
  *ctas = (long long)s.grid.x * s.grid.y * s.grid.z;
  *splits = s.splits;
  return 0;
}

}  // extern "C"
