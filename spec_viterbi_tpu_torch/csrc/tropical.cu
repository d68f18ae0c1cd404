// The dense (min,+) product for Hopper (sm_90a): svt_minplus.
//
//   C[g, i, j] = min_k A_g[i, k] + B[g, k, j]
//
// with A_g = A[a_idx[g]] when an index vector is given, else A[g] (one
// shared A when its stride_g is 0). A is read through the strides it is
// given (stride_g, stride_i, stride_k), so both layouts of the decoder need
// no transpose: the untransposed transition matrix of the batched TN step
// (stride_i = 1) and the row-major operators of the matvec and of the
// specializer (stride_k = 1); any other strides take scalar copies. B and C
// are contiguous [G, K, J] and [G, I, J]. An optional int32 argmin[g, i, j]
// takes the lowest k among the minima (strict < in k order; a tie between
// infinities never adopts a k, and a row that is all +inf points to 0), the
// numpy oracle's argmin.
//
// An optional epilogue makes one launch the decoder's whole step (G = 1):
//
//   C[i, j] = (t < len[j]) ? em[i, s_j] + min_k(...) : B[row0 + i, j]
//
// with s_j = obs[j] (the batch step's symbols) or the scalar o (J = 1), and
// the mask only where lengths are given. row0 is 0 for the square step; a
// state-sharded step computes a block of I rows of the K-row carry B, the
// rows from row0 on. That is the JAX step
// jnp.where(keep, em_t[:, s_t] + u_t, carry), one rounded add, so it is
// bit-equal; with argmin and J = 1 the pointers go straight to the caller's
// row of its pointer tensor.
//
// What it replaces: spec_viterbi_tpu/ops/tropical.py:89
// (tropical_mm_tn_blocked, the dense batch step and add_level) and :31-43
// (tropical_mv and tropical_mv_argmin, the matvec steps), with the emission
// add and the length mask of spec_viterbi_tpu/models/decoder.py:112-130
// folded into the epilogue. These are XLA broadcast+reduce expressions; the
// JAX package has no Pallas kernel for them. The analog of cuASR's
// Srgemm<minimum, plus>.
//
// What bounds it: operations, for J > 1. Every candidate costs an f32 add
// and a min (2 I K J a product), and (min,+) has no tensor-core
// instruction, so the FP32 lanes set the pace (33.45 T such operations a
// second on an H100 SXM, probes/bounds.py): a batch step of 2,432 states by
// 56 lanes needs 0.66 G of them (19.8 us) against 24 MB of operands. The
// tiled arm keeps the issue slots on adds and mins:
//   - each thread holds a register block of TM x TN running minima (8 x 8
//     on the 56-lane and the wide tiles, 4 x 8 or 4 x 4 on the others). Its
//     rows and its columns are runs of 4 consecutive elements, so a k step
//     reads them from shared memory as float4 (ld.shared.v4): 4 vector
//     loads for 64 candidates, the next k's loaded while this k's compute.
//     Where A is k-contiguous, a thread reads 4 k of a row as one float4;
//   - the tiles of A and B pass through a ring of MP_STAGES stages in
//     shared memory, filled by 16-byte cp.async, so stage k+1 loads while
//     stage k computes. A copy whose source is not 16-byte aligned or
//     crosses the ragged edge of I, J or K is made by scalar loads (+inf
//     past the edge) into the same ring;
//   - the tile fits the lanes: 56 lanes take a 56-wide tile, not 64;
//   - few lanes give few output tiles (38 of 64 x 56 at 2,432 x 56 for 132
//     SMs), so K is split twice. Within a CTA, KS slices of threads each take
//     a share of each stage's k (8 x 8 thread tiles would leave
//     too few threads otherwise) and merge their minima through shared
//     memory, the lower k winning a tie. Across CTAs, the splits of one
//     output tile form a thread-block cluster (up to 16, the non-portable
//     size): each CTA leaves its minima in its own shared memory; after
//     cluster.sync() each reduces its share of the tile's rows over the
//     cluster's CTAs through distributed shared memory, in rank order = k
//     order with strict <, so the lowest k still wins a tie, then applies
//     the epilogue and stores. No workspace, no second launch. The cluster
//     size is chosen against the CTAs the card holds at once (read once a
//     device from cudaOccupancyMaxActiveClusters); many tiles (the
//     specializer's build) take a cluster of one.
// J = 1 (a matvec) is bytes-bound, one read of A: a warp two rows, which
// share each load of B, each lane reading 4 consecutive k as one float4
// where stride_k = 1 and the rows are 16-byte aligned, 4 such loads of
// each row in flight a lane, a shuffle reduce keeping the lower k on equal
// values.
//
// Exact f32: every candidate is rounded once, the min is exact, +inf is
// real (no finite stand-in), so the result does not depend on the order in
// which k is taken and is bit-equal to the plain PyTorch version. Offsets
// are 64-bit: a level-2 stack at 2,432 states holds 2.6e9 elements.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MP_BK = 16;          // k a stage of the ring
constexpr int MP_STAGES = 3;       // stages of the ring
constexpr int MP_ROW_WARPS = 4;    // warps (two rows each) a CTA of the J = 1 arm
constexpr int MP_ROW_DEPTH = 4;    // float4 loads of each row in flight a lane, J = 1
constexpr int MP_MAX_GRID = 65535;
constexpr int MP_MAX_CLUSTER = 16;  // above 8: the non-portable size
constexpr int MP_MAX_DEVICES = 64;

// The decoder's step, applied where C is stored (em == nullptr: none).
struct MpEpi {
  const float* em;         // em[i * em_si + s * em_so]: state i, symbol s
  long long em_si, em_so;
  const int* obs;          // [J] the step's symbols (nullptr: the scalar o)
  const int* len;          // [J] lengths (nullptr: every lane steps)
  int o, t;
  int row0;                // B's row of C's row 0: a masked lane keeps B[row0 + i, j]
};

__device__ __forceinline__ float mp_epilogue(const MpEpi& e, float m, const float* bg, int i,
                                             int j, int J) {
  if (!e.em) return m;
  if (e.len && !(e.t < __ldg(e.len + j))) return bg[(long long)(e.row0 + i) * J + j];  // the carry
  const int s = e.obs ? __ldg(e.obs + j) : e.o;
  return __ldg(e.em + i * e.em_si + s * e.em_so) + m;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ bool aligned16(const float* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ float f4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The tile geometry of one instantiation. A thread's rows and columns are
// runs of 4: row m of thread ty is (m / 4) * (BM / (TM / 4)) + 4 ty + m % 4
// where A is i-contiguous (so its rows are float4 in the [BK][BM] stage),
// ty + m * TY where A is k-contiguous (a float4 is 4 k of one row of the
// [BM][BK + 4] stage, rows strided so a warp's reads spread over banks);
// column n of thread tx is (n / 4) * (BN / (TN / 4)) + 4 tx + n % 4. KS
// slices of TX x TY threads share the tile, slice s taking the k
// [s BK / KS, (s + 1) BK / KS) of every stage.
template <int BM, int BN, int TM, int TN, int KS, bool A_I_CONTIG>
struct MpTile {
  static constexpr int TX = BN / TN, TY = BM / TM, SLICE = TX * TY, THREADS = SLICE * KS;
  static constexpr int KK = MP_BK / KS;  // k a slice takes a stage
  static constexpr int A_LD = A_I_CONTIG ? BM : MP_BK + 4;  // floats a stage row
  static constexpr int A_STAGE = A_I_CONTIG ? MP_BK * BM : BM * (MP_BK + 4);
  static constexpr int STAGE = A_STAGE + MP_BK * BN;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BM % TM == 0 && BN % TN == 0, "runs of 4");
  static_assert(BN % 4 == 0 && BM % 4 == 0, "16-byte stage rows");
  static_assert(KK % 4 == 0, "a slice takes whole float4s of k");
  __device__ static int row(int m, int ty) {
    return A_I_CONTIG ? (m / 4) * (BM / (TM / 4)) + 4 * ty + m % 4 : ty + m * TY;
  }
  __device__ static int col(int n, int tx) { return (n / 4) * (BN / (TN / 4)) + 4 * tx + n % 4; }
};

// One stage of the ring: A[i0 : i0 + BM, k0 : k0 + BK] and
// B[k0 : k0 + BK, j0 : j0 + BN], +inf past I, J and k_hi.
template <class T, int BM, int BN, bool A_I_CONTIG>
__device__ __forceinline__ void mp_load_stage(float* st, const float* ag, const float* bg,
                                              long long sa_i, long long sa_k, int I, int J,
                                              int i0, int j0, int k0, int k_hi) {
  const int tid = threadIdx.x;
  float* as = st;
  float* bs = st + T::A_STAGE;
  if (A_I_CONTIG) {
    for (int e = tid; e < MP_BK * (BM / 4); e += T::THREADS) {
      const int kk = e / (BM / 4), ii = (e % (BM / 4)) * 4;
      const int gi = i0 + ii, gk = k0 + kk;
      float* dst = as + kk * BM + ii;
      const float* src = ag + gi * sa_i + gk * sa_k;
      if (sa_i == 1 && gk < k_hi && gi + 3 < I && aligned16(src)) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dst[q] = (gk < k_hi && gi + q < I) ? __ldg(ag + (gi + q) * sa_i + gk * sa_k) : INFINITY;
      }
    }
  } else {
    for (int e = tid; e < BM * (MP_BK / 4); e += T::THREADS) {
      const int ii = e / (MP_BK / 4), kk = (e % (MP_BK / 4)) * 4;
      const int gi = i0 + ii, gk = k0 + kk;
      float* dst = as + ii * (MP_BK + 4) + kk;
      const float* src = ag + gi * sa_i + gk * sa_k;
      if (sa_k == 1 && gi < I && gk + 3 < k_hi && aligned16(src)) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dst[q] = (gi < I && gk + q < k_hi) ? __ldg(ag + gi * sa_i + (gk + q) * sa_k) : INFINITY;
      }
    }
  }
  for (int e = tid; e < MP_BK * (BN / 4); e += T::THREADS) {
    const int kk = e / (BN / 4), jj = (e % (BN / 4)) * 4;
    const int gk = k0 + kk, gj = j0 + jj;
    float* dst = bs + kk * BN + jj;
    const float* src = bg + (long long)gk * J + gj;
    if (gk < k_hi && gj + 3 < J && aligned16(src)) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[q] = (gk < k_hi && gj + q < J) ? __ldg(src + q) : INFINITY;
    }
  }
}

template <int TM, int TN, bool ARGMIN>
__device__ __forceinline__ void mp_candidates(float (&acc)[TM][TN], int (&idx)[TM][TN],
                                              const float (&av)[TM], const float (&bv)[TN], int k) {
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const float s = av[m] + bv[n];
      if (ARGMIN) {
        if (s < acc[m][n]) {
          acc[m][n] = s;
          idx[m][n] = k;
        }
      } else {
        acc[m][n] = fminf(acc[m][n], s);
      }
    }
}

// J > 1. Grid: x = tiles_j * cluster (the cluster's CTAs split K, rank r
// taking [r k_split, (r + 1) k_split)), y = tiles_i, z = products (a loop
// over g past 65,535). Dynamic shared memory: the ring and, with K slices
// or a cluster of more than one, the [BM][BN] minima (and argmins) they
// reduce over.
template <int BM, int BN, int TM, int TN, int KS, bool A_I_CONTIG, bool ARGMIN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN) * KS)
minplus_tiled(const float* __restrict__ a, const long long* __restrict__ a_idx,
              const float* __restrict__ b, float* __restrict__ c, int* __restrict__ arg,
              long long sa_g, long long sa_i, long long sa_k, int G, int I, int K, int J,
              int cluster, int k_split, MpEpi epi) {
  using T = MpTile<BM, BN, TM, TN, KS, A_I_CONTIG>;
  extern __shared__ float4 mp_smem4[];
  float* smem = reinterpret_cast<float*>(mp_smem4);
  const int tid = threadIdx.x;
  const int sl = tid / T::SLICE, lt = tid % T::SLICE;
  const int tx = lt % T::TX, ty = lt / T::TX;
  const int kk0 = sl * T::KK;
  const int rank = blockIdx.x % cluster;
  const int i0 = blockIdx.y * BM, j0 = (blockIdx.x / cluster) * BN;
  const int k_lo = (int)min((long long)K, (long long)rank * k_split);
  const int k_hi = (int)min((long long)K, (long long)k_lo + k_split);
  const int n_k = (k_hi - k_lo + MP_BK - 1) / MP_BK;
  float* red = smem;  // after the main loop: [BM][BN] minima, then argmins
  int* red_i = reinterpret_cast<int*>(smem + BM * BN);
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
#pragma unroll
    for (int s = 0; s < MP_STAGES - 1; ++s) {
      if (s < n_k)
        mp_load_stage<T, BM, BN, A_I_CONTIG>(smem + s * T::STAGE, ag, bg, sa_i, sa_k, I, J, i0, j0,
                                             k_lo + s * MP_BK, k_hi);
      cp_async_commit();
    }
    for (int it = 0; it < n_k; ++it) {
      cp_async_wait<MP_STAGES - 2>();
      __syncthreads();  // stage it has landed; stage it - 1 is free
      const int nx = it + MP_STAGES - 1;
      if (nx < n_k)
        mp_load_stage<T, BM, BN, A_I_CONTIG>(smem + (nx % MP_STAGES) * T::STAGE, ag, bg, sa_i, sa_k,
                                             I, J, i0, j0, k_lo + nx * MP_BK, k_hi);
      cp_async_commit();
      const float* as = smem + (it % MP_STAGES) * T::STAGE;
      const float* bs = as + T::A_STAGE;
      const int kb = k_lo + it * MP_BK;
      if (A_I_CONTIG) {
        // the next k's float4s load while this k's candidates compute
        float4 xa[TM / 4], xb[TN / 4];
#pragma unroll
        for (int q = 0; q < TM / 4; ++q)
          xa[q] = *reinterpret_cast<const float4*>(as + kk0 * BM + q * (BM / (TM / 4)) + 4 * ty);
#pragma unroll
        for (int p = 0; p < TN / 4; ++p)
          xb[p] = *reinterpret_cast<const float4*>(bs + kk0 * BN + p * (BN / (TN / 4)) + 4 * tx);
#pragma unroll
        for (int e = 0; e < T::KK; ++e) {
          const int kk = kk0 + e;
          float av[TM], bv[TN];
#pragma unroll
          for (int q = 0; q < TM / 4; ++q)
            av[4 * q] = xa[q].x, av[4 * q + 1] = xa[q].y, av[4 * q + 2] = xa[q].z, av[4 * q + 3] = xa[q].w;
#pragma unroll
          for (int p = 0; p < TN / 4; ++p)
            bv[4 * p] = xb[p].x, bv[4 * p + 1] = xb[p].y, bv[4 * p + 2] = xb[p].z, bv[4 * p + 3] = xb[p].w;
          if (e + 1 < T::KK) {
#pragma unroll
            for (int q = 0; q < TM / 4; ++q)
              xa[q] = *reinterpret_cast<const float4*>(as + (kk + 1) * BM + q * (BM / (TM / 4)) + 4 * ty);
#pragma unroll
            for (int p = 0; p < TN / 4; ++p)
              xb[p] = *reinterpret_cast<const float4*>(bs + (kk + 1) * BN + p * (BN / (TN / 4)) + 4 * tx);
          }
          mp_candidates<TM, TN, ARGMIN>(acc, idx, av, bv, kb + kk);
        }
      } else {
#pragma unroll 1
        for (int k4 = kk0; k4 < kk0 + T::KK; k4 += 4) {
          float4 a4[TM];
#pragma unroll
          for (int m = 0; m < TM; ++m)
            a4[m] = *reinterpret_cast<const float4*>(as + T::row(m, ty) * T::A_LD + k4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float av[TM], bv[TN];
#pragma unroll
            for (int m = 0; m < TM; ++m) av[m] = f4(a4[m], e);
#pragma unroll
            for (int p = 0; p < TN / 4; ++p) {
              const float4 y =
                  *reinterpret_cast<const float4*>(bs + (k4 + e) * BN + p * (BN / (TN / 4)) + 4 * tx);
              bv[4 * p] = y.x, bv[4 * p + 1] = y.y, bv[4 * p + 2] = y.z, bv[4 * p + 3] = y.w;
            }
            mp_candidates<TM, TN, ARGMIN>(acc, idx, av, bv, kb + k4 + e);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it holds the minima below
    if (KS > 1) {
      // the slices' minima into slice 0's registers, one slice at a time;
      // their k interleave, so a tie goes to the lower k explicitly
      for (int s = 1; s < KS; ++s) {
        if (sl == s) {
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int n = 0; n < TN; ++n) {
              const int r = T::row(m, ty) * BN + T::col(n, tx);
              red[r] = acc[m][n];
              if (ARGMIN) red_i[r] = idx[m][n];
            }
        }
        __syncthreads();
        if (sl == 0) {
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int n = 0; n < TN; ++n) {
              const int r = T::row(m, ty) * BN + T::col(n, tx);
              if (ARGMIN) {
                const float v = red[r];
                const int vi = red_i[r];
                if (v < acc[m][n] || (v == acc[m][n] && vi < idx[m][n])) {
                  acc[m][n] = v;
                  idx[m][n] = vi;
                }
              } else {
                acc[m][n] = fminf(acc[m][n], red[r]);
              }
            }
        }
        __syncthreads();
      }
    }
    if (cluster == 1) {
      if (sl == 0) {
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const int gi = i0 + T::row(m, ty);
          if (gi >= I) continue;
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const int gj = j0 + T::col(n, tx);
            if (gj >= J) continue;
            const long long o = (g * I + gi) * (long long)J + gj;
            c[o] = mp_epilogue(epi, acc[m][n], bg, gi, gj, J);
            if (ARGMIN) arg[o] = idx[m][n];
          }
        }
      }
      __syncthreads();  // the next product's ring overwrites nothing read
      continue;
    }
    if (sl == 0) {
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          const int r = T::row(m, ty) * BN + T::col(n, tx);
          red[r] = acc[m][n];
          if (ARGMIN) red_i[r] = idx[m][n];
        }
    }
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every split's minima are in its shared memory
    const int rows = min(BM, I - i0);
    const int per = (rows + cluster - 1) / cluster;
    const int r_lo = min(rows, (int)cl.block_rank() * per), r_hi = min(rows, r_lo + per);
    for (int e = tid; e < (r_hi - r_lo) * BN; e += T::THREADS) {
      const int r = r_lo + e / BN, cj = e % BN, gj = j0 + cj;
      if (gj >= J) continue;
      float v[MP_MAX_CLUSTER];  // every split's minimum in flight at once
#pragma unroll
      for (int s = 0; s < MP_MAX_CLUSTER; ++s)
        if (s < cluster) v[s] = cl.map_shared_rank(red, s)[r * BN + cj];
      float best = INFINITY;
      int bi = 0;
#pragma unroll
      for (int s = 0; s < MP_MAX_CLUSTER; ++s) {  // rank order = k order
        if (s >= cluster) break;
        if (ARGMIN) {
          if (v[s] < best) {
            best = v[s];
            bi = cl.map_shared_rank(red_i, s)[r * BN + cj];
          }
        } else {
          best = fminf(best, v[s]);
        }
      }
      const long long o = (g * I + i0 + r) * (long long)J + gj;
      c[o] = mp_epilogue(epi, best, bg, i0 + r, gj, J);
      if (ARGMIN) arg[o] = bi;
    }
    cl.sync();  // no CTA leaves, or refills its ring, while another reads it
  }
}

template <bool ARGMIN>
__device__ __forceinline__ void mp_row_candidate(float s, int k, float& best, int& bi) {
  if (ARGMIN) {
    if (s < best) {
      best = s;
      bi = k;
    }
  } else {
    best = fminf(best, s);
  }
}

// The lowest (value, k) of a warp's lanes into lane 0: the lower k on
// equal values, so the row's lowest k (an all-inf row holds k = 0).
template <bool ARGMIN>
__device__ __forceinline__ void mp_warp_min(float& best, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    if (ARGMIN) {
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ob < best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    } else {
      best = fminf(best, ob);
    }
  }
}

// J = 1: a warp two rows of A_g, which share each load of B. Where the
// rows and B are 16-byte aligned and stride_k = 1, lane l takes the
// float4s l, l + 32, ... of both rows (MP_ROW_DEPTH of each in flight),
// then the ragged tail k one a lane; else k = l, l + 32, ... one at a
// time. A lane's k ascend either way, so strict < keeps its lowest k.
template <bool ARGMIN>
__global__ void __launch_bounds__(MP_ROW_WARPS * 32)
minplus_rows(const float* __restrict__ a, const long long* __restrict__ a_idx,
             const float* __restrict__ b, float* __restrict__ c, int* __restrict__ arg,
             long long sa_g, long long sa_i, long long sa_k, int G, int I, int K, MpEpi epi) {
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * MP_ROW_WARPS + threadIdx.x / 32) * 2;
  if (row0 >= I) return;  // the whole warp: no barrier below
  const bool two = row0 + 1 < I;
  for (long long g = blockIdx.y; g < G; g += gridDim.y) {
    const float* ar0 = a + (a_idx ? a_idx[g] : g) * sa_g + row0 * sa_i;
    const float* ar1 = two ? ar0 + sa_i : ar0;  // a lone last row is taken twice, stored once
    const float* bg = b + g * K;
    float best0 = INFINITY, best1 = INFINITY;
    int bi0 = 0, bi1 = 0;
    int k_done = 0;
    if (sa_k == 1 && aligned16(ar0) && aligned16(ar1) && aligned16(bg)) {
      const float4* a0 = reinterpret_cast<const float4*>(ar0);
      const float4* a1 = reinterpret_cast<const float4*>(ar1);
      const float4* b4 = reinterpret_cast<const float4*>(bg);
      const int n4 = K / 4;
      for (int q0 = lane; q0 < n4; q0 += 32 * MP_ROW_DEPTH) {
        float4 x0[MP_ROW_DEPTH], x1[MP_ROW_DEPTH], y[MP_ROW_DEPTH];
#pragma unroll
        for (int d = 0; d < MP_ROW_DEPTH; ++d) {
          const int q = q0 + 32 * d;
          if (q < n4) {
            x0[d] = __ldg(a0 + q);
            x1[d] = __ldg(a1 + q);
            y[d] = __ldg(b4 + q);
          }
        }
#pragma unroll
        for (int d = 0; d < MP_ROW_DEPTH; ++d) {
          const int q = q0 + 32 * d;
          if (q >= n4) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mp_row_candidate<ARGMIN>(f4(x0[d], e) + f4(y[d], e), 4 * q + e, best0, bi0);
            mp_row_candidate<ARGMIN>(f4(x1[d], e) + f4(y[d], e), 4 * q + e, best1, bi1);
          }
        }
      }
      k_done = n4 * 4;
    }
    for (int k = k_done + lane; k < K; k += 32) {
      const float y = __ldg(bg + k);
      mp_row_candidate<ARGMIN>(__ldg(ar0 + k * sa_k) + y, k, best0, bi0);
      mp_row_candidate<ARGMIN>(__ldg(ar1 + k * sa_k) + y, k, best1, bi1);
    }
    mp_warp_min<ARGMIN>(best0, bi0);
    mp_warp_min<ARGMIN>(best1, bi1);
    if (lane == 0) {
      c[g * I + row0] = mp_epilogue(epi, best0, bg, row0, 0, 1);
      if (ARGMIN) arg[g * I + row0] = bi0;
      if (two) {
        c[g * I + row0 + 1] = mp_epilogue(epi, best1, bg, row0 + 1, 0, 1);
        if (ARGMIN) arg[g * I + row0 + 1] = bi1;
      }
    }
  }
}

// The tiles of the tiled arm: (BM, BN, TM, TN). Narrow tiles for the
// decoder's few lanes, each BN fitting its J; the wide one for the build.
enum MpCfg { MP_N16, MP_N32, MP_N56, MP_N64, MP_WIDE, MP_ROWS };
constexpr int MP_CFG[5][5] = {  // BM, BN, TM, TN, KS
    {64, 16, 4, 4, 1}, {64, 32, 4, 8, 1}, {64, 56, 8, 8, 2}, {64, 64, 4, 8, 1}, {128, 128, 8, 8, 1}};

struct MpShape {
  int cfg, bm, bn, tm, tn, ks, threads, cluster, k_split, stages;
  dim3 grid;
  size_t smem;
};

int tune_cluster = 0;  // svt_minplus_tune: 0 takes the shape function's choice
int sm_count[MP_MAX_DEVICES];       // read once a device

int sms_of_device(int* sms) {
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  if (dev < 0 || dev >= MP_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!sm_count[dev]) {
    rc = (int)cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (rc) return rc;
  }
  *sms = sm_count[dev];
  return 0;
}

size_t smem_bytes(int bm, int bn, bool i_contig, bool argmin, bool reduce) {
  const int a_stage = i_contig ? MP_BK * bm : bm * (MP_BK + 4);
  const size_t pipe = (size_t)MP_STAGES * (a_stage + MP_BK * bn) * 4;
  const size_t red = reduce ? (size_t)bm * bn * (argmin ? 8 : 4) : 0;
  return pipe > red ? pipe : red;
}

int minplus_launch(const MpShape& s, bool i_contig, bool argmin, cudaStream_t st, int* resident,
                   const float* a, const long long* a_idx, const float* b, float* c, int* arg,
                   long long sa_g, long long sa_i, long long sa_k, int g, int i, int k, int j,
                   const MpEpi& epi);

// CTAs of a tiled launch the card holds at once, by tile, layout, argmin
// and cluster size (1, 2, 4, 8, 16): read once a device (0: not yet).
int capacity[MP_MAX_DEVICES][MP_ROWS][2][2][5];

// J = 1 takes the row arm. Otherwise the narrowest tile that holds J
// (J > 64: the wide tile), then the cluster size S of 1, 2, 4, 8 or 16
// (other sizes measured slower) that minimises the waves of CTAs the card
// holds at once times each split's stages, plus two for the ring's fill
// and the reduction: a larger S splits K finer, but past one wave its CTAs
// queue. K shorter than S stages leaves the last splits empty.
int minplus_shape(int g, int i, int k, int j, bool i_contig, bool argmin, MpShape* s) {
  const int gz = g < MP_MAX_GRID ? g : MP_MAX_GRID;
  if (j == 1) {
    *s = {MP_ROWS, 1, 1, 2, 4, 1, MP_ROW_WARPS * 32, 1, k, 0,
          dim3((i + 2 * MP_ROW_WARPS - 1) / (2 * MP_ROW_WARPS), gz), 0};
    return 0;
  }
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  if (dev < 0 || dev >= MP_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int cfg = j <= 16 ? MP_N16 : j <= 32 ? MP_N32 : j <= 56 ? MP_N56 : j <= 64 ? MP_N64 : MP_WIDE;
  const int bm = MP_CFG[cfg][0], bn = MP_CFG[cfg][1], tm = MP_CFG[cfg][2], tn = MP_CFG[cfg][3];
  const int ks = MP_CFG[cfg][4];
  const int threads = (bm / tm) * (bn / tn) * ks;
  const int tiles_i = (i + bm - 1) / bm, tiles_j = (j + bn - 1) / bn;
  if (tiles_i > MP_MAX_GRID) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)tiles_i * tiles_j * gz;
  const int stages = (k + MP_BK - 1) / MP_BK;
  auto shape_of = [&](int cluster) -> MpShape {
    int k_split = (stages + cluster - 1) / cluster * MP_BK;
    if (k_split < MP_BK) k_split = MP_BK;
    return {cfg, bm, bn, tm, tn, ks, threads, cluster, k_split, MP_STAGES,
            dim3(tiles_j * cluster, tiles_i, gz),
            smem_bytes(bm, bn, i_contig, argmin, cluster > 1 || ks > 1)};
  };
  int cluster = 1;
  if (tune_cluster > 0) {
    cluster = tune_cluster < MP_MAX_CLUSTER ? tune_cluster : MP_MAX_CLUSTER;
  } else {
    long long best = -1;
    for (int e = 0, c = 1; c <= MP_MAX_CLUSTER && (c == 1 || c <= stages); ++e, c *= 2) {
      int& cap = capacity[dev][cfg][i_contig][argmin][e];
      if (!cap) {
        rc = minplus_launch(shape_of(c), i_contig, argmin, nullptr, &cap, nullptr, nullptr, nullptr,
                            nullptr, nullptr, 0, 0, 0, 0, 0, 0, 0, MpEpi{});
        if (rc) return rc;
        if (cap < 1) cap = 1;
      }
      const long long est = (tiles * c + cap - 1) / cap * ((stages + c - 1) / c + 2);
      if (best < 0 || est < best) {
        best = est;
        cluster = c;
      }
    }
  }
  if ((long long)tiles_j * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *s = shape_of(cluster);
  return 0;
}

// One launch of the tiled arm in the shape s or, where resident is not
// null, no launch: the CTAs of that launch the card holds at once
// (cudaOccupancyMaxActiveClusters for a cluster).
template <int CFG, bool I_CONTIG, bool ARGMIN>
int launch_tiled(const MpShape& s, cudaStream_t st, int* resident, const float* a,
                 const long long* a_idx, const float* b, float* c, int* arg, long long sa_g,
                 long long sa_i, long long sa_k, int g, int i, int k, int j, const MpEpi& epi) {
  constexpr int BM = MP_CFG[CFG][0], BN = MP_CFG[CFG][1], TM = MP_CFG[CFG][2], TN = MP_CFG[CFG][3];
  constexpr int KS = MP_CFG[CFG][4];
  auto kern = minplus_tiled<BM, BN, TM, TN, KS, I_CONTIG, ARGMIN>;
  static bool attrs_set[MP_MAX_DEVICES];  // per instantiation and device
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  if (!attrs_set[dev]) {
    rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(BM, BN, I_CONTIG, ARGMIN, true));
    if (!rc) rc = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc) return rc;
    attrs_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = s.grid;
  cfg.blockDim = dim3(s.threads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident) {
    int n = 0;
    rc = (int)cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    *resident = n * s.cluster;
    return rc;
  }
  return (int)cudaLaunchKernelEx(&cfg, kern, a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j,
                                 s.cluster, s.k_split, epi);
}

template <int CFG>
int launch_cfg(const MpShape& s, bool i_contig, bool argmin, cudaStream_t st, int* resident,
               const float* a, const long long* a_idx, const float* b, float* c, int* arg,
               long long sa_g, long long sa_i, long long sa_k, int g, int i, int k, int j,
               const MpEpi& epi) {
  if (i_contig)
    return argmin ? launch_tiled<CFG, true, true>(s, st, resident, a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, epi)
                  : launch_tiled<CFG, true, false>(s, st, resident, a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, epi);
  return argmin ? launch_tiled<CFG, false, true>(s, st, resident, a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, epi)
                : launch_tiled<CFG, false, false>(s, st, resident, a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, epi);
}

// The launch of shape s (or, with resident, its resident CTAs).
int minplus_launch(const MpShape& s, bool i_contig, bool argmin, cudaStream_t st, int* resident,
                   const float* a, const long long* a_idx, const float* b, float* c, int* arg,
                   long long sa_g, long long sa_i, long long sa_k, int g, int i, int k, int j,
                   const MpEpi& epi) {
  if (s.cfg == MP_ROWS) {
    if (resident) {
      int n = 0, sms = 0;
      int rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, argmin ? minplus_rows<true> : minplus_rows<false>, s.threads, 0);
      if (!rc) rc = sms_of_device(&sms);
      *resident = n * sms;
      return rc;
    }
    if (argmin)
      minplus_rows<true><<<s.grid, s.threads, 0, st>>>(a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, epi);
    else
      minplus_rows<false><<<s.grid, s.threads, 0, st>>>(a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, epi);
    return 0;
  }
  switch (s.cfg) {
    case MP_N16: return launch_cfg<MP_N16>(s, i_contig, argmin, st, resident, a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, epi);
    case MP_N32: return launch_cfg<MP_N32>(s, i_contig, argmin, st, resident, a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, epi);
    case MP_N56: return launch_cfg<MP_N56>(s, i_contig, argmin, st, resident, a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, epi);
    case MP_N64: return launch_cfg<MP_N64>(s, i_contig, argmin, st, resident, a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, epi);
    default: return launch_cfg<MP_WIDE>(s, i_contig, argmin, st, resident, a, a_idx, b, c, arg, sa_g, sa_i, sa_k, g, i, k, j, epi);
  }
}

bool a_i_contig(long long sa_i, long long sa_k) { return sa_i == 1 && sa_k != 1; }

}  // namespace

extern "C" {

// argmin (nullptr: none) and a_idx (nullptr: A_g = A[g]) are optional.
// The caller allocates c and argmin, [g, i, j] each. em (nullptr: no
// epilogue) with its strides over states and symbols, obs ([j] int32, or
// nullptr and the scalar o), lengths ([j] int32 or nullptr) and t give the
// decoder's step (g = 1; with lengths, b is the carry and row0 + i <= k:
// a masked lane keeps b[row0 + r, j] in c[r, j]).
int svt_minplus(const float* a, const long long* a_idx, const float* b, float* c, int* argmin,
                long long sa_g, long long sa_i, long long sa_k, int g, int i, int k, int j,
                const float* em, long long em_si, long long em_so, const int* obs, int o,
                const int* lengths, int t, int row0, void* stream) {
  if (g <= 0 || i <= 0 || j <= 0) return 0;
  const bool i_contig = a_i_contig(sa_i, sa_k);
  MpShape s;
  int rc = minplus_shape(g, i, k, j, i_contig, argmin != nullptr, &s);
  if (rc) return rc;
  if (lengths && (row0 < 0 || (long long)row0 + i > k)) return (int)cudaErrorInvalidValue;
  const MpEpi epi = {em, em_si, em_so, obs, lengths, o, t, row0};
  rc = minplus_launch(s, i_contig, argmin != nullptr, (cudaStream_t)stream, nullptr, a, a_idx, b, c,
                      argmin, sa_g, sa_i, sa_k, g, i, k, j, epi);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// The shape svt_minplus launches for a [g, i, j] output over k in the
// layout of (sa_i, sa_k), with or without argmin: out[0..9] = tile rows
// and columns (1 x 1: the row arm), thread tile rows and columns (2 x 4
// on the row arm: a warp's two rows, a lane's float4 of k), K slices a
// CTA, threads a CTA, cluster size (the CTAs that split K), k a split,
// stages of the ring (0: none), and the CTAs of the launch the card holds
// at once; ctas = CTAs in all.
int svt_minplus_shape(int g, int i, int k, int j, long long sa_i, long long sa_k, int argmin,
                      int* out, long long* ctas) {
  MpShape s;
  const bool i_contig = a_i_contig(sa_i, sa_k);
  int rc = minplus_shape(g, i, k, j, i_contig, argmin != 0, &s);
  if (rc) return rc;
  int resident = 0;
  rc = minplus_launch(s, i_contig, argmin != 0, nullptr, &resident, nullptr, nullptr, nullptr,
                      nullptr, nullptr, 0, sa_i, sa_k, g, i, k, j, MpEpi{});
  if (rc) return rc;
  const int v[10] = {s.bm, s.bn, s.tm, s.tn, s.ks, s.threads, s.cluster, s.k_split, s.stages, resident};
  for (int q = 0; q < 10; ++q) out[q] = v[q];
  *ctas = (long long)s.grid.x * s.grid.y * s.grid.z;
  return 0;
}

// Pins the cluster size (1-16) of the tiled arm, for tests and
// measurements; 0 restores the shape function's choice.
void svt_minplus_tune(int cluster) { tune_cluster = cluster; }

}  // extern "C"
