// Probe kernels for Hopper (sm_90a): the H100 counterparts of the TPU
// probes under scripts/, each with a plain C entry point loaded through
// ctypes by spec_viterbi_tpu_torch/ops/probes.py.
//
//   svt_probe_pass      replaces scripts/exp_roofline.py::_micro_pallas (the
//                       micro_* bodies, stage 1 and 3b) and
//                       scripts/exp_fs_laneblock2.py::empty_run: P passes of
//                       one primitive class per step over a lane's carry;
//                       and the chase classes, the dependent pointer walk
//                       of svt_backtrace, P hops a step.
//   svt_probe_emsel     replaces scripts/exp_mxu_precision.py::
//                       micro_mxu_prec: P emission selects per step, by a
//                       direct read or by mma.sync against a one-hot.
//
// The third probe kernel, svt_scores_variant (the ablated B1 bodies), is
// the generic arm of the masked scores kernel itself with compile-time
// flags (csrc/generic.cuh), in csrc/variants.cu.
//
// A probe measures, it serves no request: the pass and select probes
// compute what the TPU bodies compute (tests/test_torch_probes.py holds
// their plain versions bit-equal to the JAX bodies in interpret mode) at the
// port's production shape: one CTA of 256 threads per lane, the lane's [n]
// carry double-buffered in shared memory, one barrier per step. What bounds
// them is what bounds the production kernels: the latency of the per-step
// chain, a pass over n states and a block barrier, not bytes (each step
// reads one table row of n floats at most, from L2). So each probe times a
// whole T-step loop, and a pass's cost is the slope of the loop's time
// over P. Built without --use_fast_math, so every add rounds once and the
// kernels equal their plain versions bit for bit.

#include "common.cuh"

// ---- svt_probe_pass -------------------------------------------------------

#define PROBE_COLS 16       // columns of the cols operand ([16][n])
#define PROBE_COLRED_CAP 8  // colred partial mins kept in registers
#define PROBE_SYMBOLS 20    // the probes' alphabet: symbol (o + k) mod 20
#define TWOSYM_RANK1 5      // rank-1 applies of the composed two-symbol step

// Pass classes; ops/probes.py mirrors the numbering.
enum { PC_EMPTY = 0, PC_STREAM, PC_NEIGHBOUR, PC_COLRED, PC_BCAST, PC_EMISSION, PC_TWOSYM, PC_CHASE,
       PC_CHASE_HBM };

// The bcast sources (37 k) mod n, k < PROBE_COLS, passed by value so the
// kernel reads them from the constant bank, as the production kernels read
// their dense-row sources from the descriptor.
struct BcastSrc {
  int s[PROBE_COLS];
};

// One step of every class but colred and twosym, elementwise over states:
//   acc = v[i] + add;  acc = min(acc, X_k(i)) for k < p;  v'[i] = acc
// with X_k the class's candidate (exp_roofline.py:177-302):
//   stream     bufs[k][i] + cols[k][i]       (bufs [P][n], read from L2)
//   neighbour  cols[k][i] + v[(i - (k%7+1)) mod n]   (the TPU's roll)
//   bcast      cols[k][i] + v[(37k) mod n]
//   emission   em[(o_t + k) mod 20][i]       (em [E][n], the direct read)
// empty has p = 0: add is 0.5, or the step's symbol when obs is given
// (exp_fs_laneblock2.py::empty_run, which adds the symbol). LANES > 1 (empty
// only) puts several lanes' carries in one CTA.
template <int CLS, int LANES>
__device__ __forceinline__ void pass_step(const float* cur, float* nxt, const float* __restrict__ cols,
                                          const float* __restrict__ bufs, const float* __restrict__ tab,
                                          const int* __restrict__ obs, const BcastSrc& bsrc, int n,
                                          int batch, int b0, int t, int p) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int l = 0; l < LANES; ++l) {
    const int b = b0 + l;
    float add = 0.5f;
    if (CLS == PC_EMPTY && obs != nullptr) add = (float)obs[(size_t)t * batch + b];
    const int sym = CLS == PC_EMISSION ? obs[(size_t)t * batch + b] : 0;
    const float* c = cur + l * n;
    float* x = nxt + l * n;
    for (int i = tid; i < n; i += SVT_THREADS) {
      float acc = c[i] + add;
      for (int k = 0; k < p; ++k) {
        float cand = INFINITY;
        if (CLS == PC_STREAM) {
          cand = bufs[(size_t)k * n + i] + cols[(size_t)k * n + i];
        } else if (CLS == PC_NEIGHBOUR) {
          int j = i - (k % 7 + 1);
          if (j < 0) j += n;
          cand = cols[(size_t)k * n + i] + c[j];
        } else if (CLS == PC_BCAST) {
          cand = cols[(size_t)k * n + i] + c[bsrc.s[k]];
        } else if (CLS == PC_EMISSION) {
          cand = tab[(size_t)((sym + k) % PROBE_SYMBOLS) * n + i];
        }
        acc = fminf(acc, cand);
      }
      x[i] = acc;
    }
  }
}

// chase and chase_hbm (LANES = 1): the chain of svt_backtrace alone. Warp
// 0 walks p dependent hops a step from state b mod n, through an [n]
// int16 table copied into shared memory (chase) or through rows (t p + k)
// mod e of an [e][batch][n] int16 table in device memory (chase_hbm: 4 GB
// and more, so each hop misses L2 and the TLB, as the old backtrace's
// loads did); the carry passes through and row 0 of the output holds the
// final state.
template <int CLS, int LANES>
__global__ void __launch_bounds__(SVT_THREADS)
probe_pass_kernel(const float* __restrict__ v0, const float* __restrict__ cols,
                  const float* __restrict__ bufs, const float* __restrict__ tab,
                  const int* __restrict__ obs, const BcastSrc bsrc, float* __restrict__ out, int n,
                  int batch, int steps, int p, int e) {
  constexpr bool kChase = CLS == PC_CHASE || CLS == PC_CHASE_HBM;
  extern __shared__ float carry[];  // [2][LANES][n]; chase: then the [n] int16 table
  __shared__ float red[SVT_WARPS][PROBE_COLRED_CAP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * LANES;
  const short* ptab = reinterpret_cast<const short*>(tab);
  short* chase_tab = reinterpret_cast<short*>(carry + 2 * LANES * n);
  int state = b0 % n;
  for (int l = 0; l < LANES; ++l)
    for (int i = tid; i < n; i += SVT_THREADS) carry[l * n + i] = v0[(size_t)i * batch + b0 + l];
  if (CLS == PC_CHASE)
    for (int i = tid; i < n; i += SVT_THREADS) chase_tab[i] = ptab[i];
  __syncthreads();

  float* cur = carry;
  float* nxt = carry + LANES * n;
  // twosym consumes two symbols a step
  const int t_end = CLS == PC_TWOSYM ? steps / 2 : steps;
  for (int t = 0; t < t_end; ++t) {
    if (CLS == PC_COLRED) {
      // p block-wide min reduces of cols[k] + v, as the production kernel
      // reduces its dense columns; then v' = min(v + 0.5, min_k m_k + 4)
      float part[PROBE_COLRED_CAP];
#pragma unroll
      for (int k = 0; k < PROBE_COLRED_CAP; ++k) part[k] = INFINITY;
      for (int i = tid; i < n; i += SVT_THREADS) {
        const float v = cur[i];
#pragma unroll
        for (int k = 0; k < PROBE_COLRED_CAP; ++k)
          if (k < p) part[k] = fminf(part[k], cols[(size_t)k * n + i] + v);
      }
#pragma unroll
      for (int k = 0; k < PROBE_COLRED_CAP; ++k) {
        if (k < p) {
          const float m = warp_min(part[k]);
          if (lane == 0) red[warp][k] = m;
        }
      }
      __syncthreads();
      float extra = INFINITY;
      for (int w = 0; w < SVT_WARPS; ++w)
        for (int k = 0; k < p; ++k) extra = fminf(extra, red[w][k]);
      const float e4 = extra + 4.0f;
      for (int i = tid; i < n; i += SVT_THREADS) nxt[i] = fminf(cur[i] + 0.5f, e4);
    } else if (CLS == PC_TWOSYM) {
      // the composed two-symbol step (exp_roofline.py::micro_twosym): one
      // diagonal at offset 2, five rank-1 applies (a block-wide min of
      // T[1+2k] + v, broadcast into T[2+2k] + m_k), the final emission;
      // tab [12][e][n], rows 0..10 taken at the middle symbol, row 11 at
      // the end symbol: 12 rows read per 2 symbols
      const int b = b0;
      const int s_mid = obs[(size_t)(2 * t) * batch + b];
      const int s_end = obs[(size_t)(2 * t + 1) * batch + b];
      const float* mid = tab + (size_t)s_mid * n;
      const size_t tstride = (size_t)e * n;
      float part[TWOSYM_RANK1];
#pragma unroll
      for (int k = 0; k < TWOSYM_RANK1; ++k) part[k] = INFINITY;
      for (int i = tid; i < n; i += SVT_THREADS) {
        const float v = cur[i];
#pragma unroll
        for (int k = 0; k < TWOSYM_RANK1; ++k)
          part[k] = fminf(part[k], mid[(1 + 2 * k) * tstride + i] + v);
      }
#pragma unroll
      for (int k = 0; k < TWOSYM_RANK1; ++k) {
        const float m = warp_min(part[k]);
        if (lane == 0) red[warp][k] = m;
      }
      __syncthreads();
      float m[TWOSYM_RANK1];
#pragma unroll
      for (int k = 0; k < TWOSYM_RANK1; ++k) {
        m[k] = INFINITY;
        for (int w = 0; w < SVT_WARPS; ++w) m[k] = fminf(m[k], red[w][k]);
      }
      const float* end = tab + 11 * tstride + (size_t)s_end * n;
      for (int i = tid; i < n; i += SVT_THREADS) {
        int j = i - 2;
        if (j < 0) j += n;
        float acc = mid[i] + cur[j];
#pragma unroll
        for (int k = 0; k < TWOSYM_RANK1; ++k) acc = fminf(acc, mid[(2 + 2 * k) * tstride + i] + m[k]);
        nxt[i] = end[i] + acc;
      }
    } else if (kChase) {
      if (warp == 0) {
        for (int k = 0; k < p; ++k) {
          if (CLS == PC_CHASE)
            state = chase_tab[state];
          else
            state = ptab[((size_t)((t * p + k) % e) * batch + b0) * n + state];
        }
      }
    } else {
      pass_step<CLS, LANES>(cur, nxt, cols, bufs, tab, obs, bsrc, n, batch, b0, t, p);
    }
    __syncthreads();
    if (!kChase) {
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  for (int l = 0; l < LANES; ++l)
    for (int i = tid; i < n; i += SVT_THREADS) out[(size_t)i * batch + b0 + l] = cur[l * n + i];
  if (kChase && tid == 0) out[b0] = (float)state;
}

template <int CLS, int LANES>
static int launch_pass(const float* v0, const float* cols, const float* bufs, const float* tab,
                       const int* obs, float* out, int n, int batch, int steps, int p, int e,
                       void* stream) {
  size_t smem = 2 * (size_t)LANES * n * sizeof(float);
  if (CLS == PC_CHASE) smem += ((size_t)n * sizeof(short) + 3) / 4 * 4;
  int rc = set_smem((const void*)probe_pass_kernel<CLS, LANES>, smem);
  if (rc) return rc;
  BcastSrc bsrc;
  for (int k = 0; k < PROBE_COLS; ++k) bsrc.s[k] = (37 * k) % n;
  probe_pass_kernel<CLS, LANES><<<batch / LANES, SVT_THREADS, smem, (cudaStream_t)stream>>>(
      v0, cols, bufs, tab, obs, bsrc, out, n, batch, steps, p, e);
  return (int)cudaGetLastError();
}

// ---- svt_probe_emsel ------------------------------------------------------
//
// P emission selects per step, acc = min(v + 0.5, sel_0 .. sel_{P-1}),
// sel_k the column (o_t + k) mod 20 of the emission table: the TPU ladder
// of exp_mxu_precision.py, which selects on the MXU by a dot with a
// one-hot. Schemes (ops/probes.py mirrors the numbering):
//   gather  the direct f32 read em[s][i] (what production does)
//   tf32    one mma.sync m16n8k8 tf32 pass of the table against the one-hot
//   bf16    one mma.sync m16n8k16 bf16 pass
//   split2  two bf16 passes, hi + lo of the exact-residual split
//   split3  three bf16 passes, hi + lo + lo2
// all accumulating in f32. The products are x * 1 or x * 0, so each select
// is exact in the table's rounding: the tables arrive pre-rounded (tf32
// values, bf16 terms) and the kernels equal the plain versions bit for bit.
//
// A CTA owns 8 lanes (the n of m16n8k16) with a [n][8] carry in shared
// memory, one tile of 16 states x 8 lanes per warp at a time; every scheme
// uses this layout, so the schemes differ only in the select. The table
// must be finite: a one-hot product of +inf is inf * 0 = NaN. That is one
// reason production never selects this way (the TPU kernels clamp +inf to
// a finite BIG for it); the other is that a direct read costs one load per
// state, against 2-6 mma passes over all 32 table rows.

#define EMSEL_LANES 8
#define EMSEL_E 32  // table rows: the one-hot's depth (E_PAD)

enum { ES_GATHER = 0, ES_TF32, ES_BF16, ES_SPLIT2, ES_SPLIT3 };

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  const float c0 = d[0], c1 = d[1], c2 = d[2], c3 = d[3];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c0), "f"(c1),
        "f"(c2), "f"(c3));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  const float c0 = d[0], c1 = d[1], c2 = d[2], c3 = d[3];
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c0), "f"(c1),
        "f"(c2), "f"(c3));
}

// two bf16 values, the lower-indexed one in the low half
__device__ __forceinline__ unsigned pack_bf16(unsigned short lo, unsigned short hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

// The select of one 16 x 8 tile (states m0.., the CTA's 8 lanes) into the
// C-fragment layout: d[0] (row g, lane 2q), d[1] (g, 2q+1), d[2] (g+8, 2q),
// d[3] (g+8, 2q+1); s0, s1 the symbols of lanes 2q and 2q+1, sb the symbol
// of lane g (the B fragment's column).
template <int SCHEME>
__device__ __forceinline__ void emsel_tile(const void* __restrict__ tab_raw, int n, int m0, int g,
                                           int q, int s0, int s1, int sb, float (&d)[4]) {
  if (SCHEME == ES_GATHER) {
    const float* tab = (const float*)tab_raw;
    d[0] = tab[(size_t)s0 * n + m0 + g];
    d[1] = tab[(size_t)s1 * n + m0 + g];
    d[2] = tab[(size_t)s0 * n + m0 + g + 8];
    d[3] = tab[(size_t)s1 * n + m0 + g + 8];
    return;
  }
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  if (SCHEME == ES_TF32) {
    const unsigned* tab = (const unsigned*)tab_raw;  // tf32-rounded f32 bits [E][n]
    const unsigned one = 0x3f800000u;
#pragma unroll
    for (int kb = 0; kb < EMSEL_E; kb += 8) {
      const unsigned a[4] = {tab[(size_t)(kb + q) * n + m0 + g], tab[(size_t)(kb + q) * n + m0 + g + 8],
                             tab[(size_t)(kb + q + 4) * n + m0 + g],
                             tab[(size_t)(kb + q + 4) * n + m0 + g + 8]};
      const unsigned b[2] = {kb + q == sb ? one : 0u, kb + q + 4 == sb ? one : 0u};
      mma_tf32(d, a, b);
    }
    return;
  }
  constexpr int terms = SCHEME == ES_BF16 ? 1 : SCHEME == ES_SPLIT2 ? 2 : 3;
  const unsigned short* tab = (const unsigned short*)tab_raw;  // bf16 bits [terms][E][n]
  const unsigned short one = 0x3f80;
#pragma unroll
  for (int j = 0; j < terms; ++j) {
    const unsigned short* tj = tab + (size_t)j * EMSEL_E * n;
#pragma unroll
    for (int kb = 0; kb < EMSEL_E; kb += 16) {
      const int k0 = kb + 2 * q;
      const unsigned a[4] = {
          pack_bf16(tj[(size_t)k0 * n + m0 + g], tj[(size_t)(k0 + 1) * n + m0 + g]),
          pack_bf16(tj[(size_t)k0 * n + m0 + g + 8], tj[(size_t)(k0 + 1) * n + m0 + g + 8]),
          pack_bf16(tj[(size_t)(k0 + 8) * n + m0 + g], tj[(size_t)(k0 + 9) * n + m0 + g]),
          pack_bf16(tj[(size_t)(k0 + 8) * n + m0 + g + 8], tj[(size_t)(k0 + 9) * n + m0 + g + 8])};
      const unsigned b[2] = {
          pack_bf16(k0 == sb ? one : 0, k0 + 1 == sb ? one : 0),
          pack_bf16(k0 + 8 == sb ? one : 0, k0 + 9 == sb ? one : 0)};
      mma_bf16(d, a, b);
    }
  }
}

template <int SCHEME>
__global__ void __launch_bounds__(SVT_THREADS)
probe_emsel_kernel(const float* __restrict__ v0, const void* __restrict__ tab,
                   const int* __restrict__ obs, float* __restrict__ out, int n, int batch,
                   int steps, int p) {
  extern __shared__ float carry[];  // [n][8]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;  // mma group and thread in group
  const int b0 = blockIdx.x * EMSEL_LANES;
  for (int idx = tid; idx < n * EMSEL_LANES; idx += SVT_THREADS)
    carry[idx] = v0[(size_t)(idx >> 3) * batch + b0 + (idx & 7)];
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int* o = obs + (size_t)t * batch + b0;
    const int o0 = o[2 * q], o1 = o[2 * q + 1], ob = o[g];
    // warp-uniform tile loop: every lane of a warp takes part in each mma
    for (int m0 = warp * 16; m0 < n; m0 += SVT_WARPS * 16) {
      float* r0 = carry + (size_t)(m0 + g) * EMSEL_LANES + 2 * q;
      float* r1 = r0 + 8 * EMSEL_LANES;
      float acc[4] = {r0[0] + 0.5f, r0[1] + 0.5f, r1[0] + 0.5f, r1[1] + 0.5f};
      for (int k = 0; k < p; ++k) {
        float d[4];
        emsel_tile<SCHEME>(tab, n, m0, g, q, (o0 + k) % PROBE_SYMBOLS, (o1 + k) % PROBE_SYMBOLS,
                           (ob + k) % PROBE_SYMBOLS, d);
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[x] = fminf(acc[x], d[x]);
      }
      r0[0] = acc[0];
      r0[1] = acc[1];
      r1[0] = acc[2];
      r1[1] = acc[3];
    }
    __syncthreads();  // the production step's barrier
  }
  for (int idx = tid; idx < n * EMSEL_LANES; idx += SVT_THREADS)
    out[(size_t)(idx >> 3) * batch + b0 + (idx & 7)] = carry[idx];
}

template <int SCHEME>
static int launch_emsel(const float* v0, const void* tab, const int* obs, float* out, int n,
                        int batch, int steps, int p, void* stream) {
  const size_t smem = (size_t)n * EMSEL_LANES * sizeof(float);
  int rc = set_smem((const void*)probe_emsel_kernel<SCHEME>, smem);
  if (rc) return rc;
  probe_emsel_kernel<SCHEME><<<batch / EMSEL_LANES, SVT_THREADS, smem, (cudaStream_t)stream>>>(
      v0, tab, obs, out, n, batch, steps, p);
  return (int)cudaGetLastError();
}

extern "C" {

int svt_probe_pass(int cls, int lanes, const float* v0, const float* cols, const float* bufs,
                   const float* tab, const int* obs, float* out, int n, int batch, int steps,
                   int p, int e, void* stream) {
  if (lanes != 1) {
    if (cls != PC_EMPTY) return (int)cudaErrorInvalidValue;
    if (lanes == 2)
      return launch_pass<PC_EMPTY, 2>(v0, cols, bufs, tab, obs, out, n, batch, steps, p, e, stream);
    if (lanes == 4)
      return launch_pass<PC_EMPTY, 4>(v0, cols, bufs, tab, obs, out, n, batch, steps, p, e, stream);
    return (int)cudaErrorInvalidValue;
  }
#define SVT_PASS(C) \
  case C:           \
    return launch_pass<C, 1>(v0, cols, bufs, tab, obs, out, n, batch, steps, p, e, stream)
  switch (cls) {
    SVT_PASS(PC_EMPTY);
    SVT_PASS(PC_STREAM);
    SVT_PASS(PC_NEIGHBOUR);
    SVT_PASS(PC_COLRED);
    SVT_PASS(PC_BCAST);
    SVT_PASS(PC_EMISSION);
    SVT_PASS(PC_TWOSYM);
    SVT_PASS(PC_CHASE);
    SVT_PASS(PC_CHASE_HBM);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_PASS
}

int svt_probe_emsel(int scheme, const float* v0, const void* tab, const int* obs, float* out,
                    int n, int batch, int steps, int p, void* stream) {
  switch (scheme) {
    case ES_GATHER:
      return launch_emsel<ES_GATHER>(v0, tab, obs, out, n, batch, steps, p, stream);
    case ES_TF32:
      return launch_emsel<ES_TF32>(v0, tab, obs, out, n, batch, steps, p, stream);
    case ES_BF16:
      return launch_emsel<ES_BF16>(v0, tab, obs, out, n, batch, steps, p, stream);
    case ES_SPLIT2:
      return launch_emsel<ES_SPLIT2>(v0, tab, obs, out, n, batch, steps, p, stream);
    case ES_SPLIT3:
      return launch_emsel<ES_SPLIT3>(v0, tab, obs, out, n, batch, steps, p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
