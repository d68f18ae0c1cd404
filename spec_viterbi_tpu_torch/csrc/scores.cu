// Whole-sequence structured Viterbi scores kernels for Hopper (sm_90a).
//
// The kernels, each with a plain C entry point loaded through ctypes by
// spec_viterbi_tpu_torch/ops/fused.py (built by ops/_build.py):
//
//   svt_scores_masked  replaces spec_viterbi_tpu/ops/fused_pallas.py::
//                      _make_unrolled_kernel without plans (masked, any
//                      fused-eligible operator: diagonals, dense rows,
//                      dense columns and at most MAX_RES residual entries):
//                      the generic arm, generic_kernel<L, C_CAP, false, 0, *>
//                      of csrc/generic.cuh (redesigned for this card, see
//                      there: L lanes a CTA, the operator in shared memory
//                      once a launch, one barrier a step, the column
//                      minima folded from v_new, the special rows formed
//                      before the barrier by the patch warp).
//   svt_scores_masked_planned
//                      replaces _make_unrolled_kernel with its col_plan and
//                      row_plan (fused_pallas.py:289-343, launched with
//                      them at :1310): the planned arm, for the operators
//                      of the FS class, masked (scores_planned_kernel).
//   svt_scores_fs      replaces spec_viterbi_tpu/ops/fused_pallas.py::
//                      _make_fs_kernel (unmasked; one diagonal, uniform
//                      dense rows, one shared column reduce plus scalar
//                      fixes): the same step with one barrier, emissions
//                      fetched a step ahead (scores_fs_kernel, below).
//
// The planned arm exists because the generic step pays for what the plans
// make scalar: a per-column reduce of every dense column and a full rv
// vector read per dense row. With the plans the step is the FS kernel's:
// one shared column min folded into the bulk pass from v_new, one scalar
// uniform-row candidate, and a flattened table of scalar candidates for
// the special rows. The mask costs nothing here: a lane that is done
// leaves its loop.
//
// A third entry point, svt_scores_variant (csrc/variants.cu, loaded by
// ops/probes.py), launches the generic arm's template with compile-time
// flags that strip or change one part of its step (csrc/generic.cuh), so
// the probes' ablations always time the kernel that production runs.
//
// Recurrence per lane b, in -log2 space with +inf as the semiring zero:
//   v'[i] = em[o_t][i] + min(candidates of row i),
// every candidate one f32 add, rounded once, and min exact, so the result
// is bit-equal to the numpy oracle and to the plain PyTorch versions.
// Build without --use_fast_math: flush-to-zero or approximate adds would
// break that.
//
// What bounds them: a serial loop over T steps, each ending in a block
// barrier; the bytes per step are small (one f32 emission row of n floats
// a lane, read from L2). So the cost is the latency of the step's chain
// and, at many lanes, the SM's issue rate, not bandwidth. Each design keeps
// a lane's [n] carry in shared memory for the whole sequence
// (double-buffered, 2 * n * 4 bytes) and makes one pass over the states
// per step.

#include "generic.cuh"

// The planned arm of svt_scores_masked: lane b takes lane_steps(lengths,
// b, steps) steps and leaves the loop, which is the whole mask, since one
// CTA owns one lane. Two barriers a step: the bulk pass, then warp 0
// patches the special rows.
__global__ void __launch_bounds__(SVT_THREADS)
scores_planned_kernel(const FsDesc desc, const float* __restrict__ dv,
                      const unsigned char* __restrict__ flags, const float* __restrict__ em,
                      const float* __restrict__ v0, const int* __restrict__ obs,
                      float* __restrict__ out, int batch, int steps,
                      const int* __restrict__ lengths) {
  extern __shared__ float carry[];  // [2][n]
  __shared__ float red[SVT_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int n = desc.n, d = desc.d;
  const int my_steps = lane_steps(lengths, b, steps);

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
  for (int t = 0; t < my_steps; ++t) {
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

// ---- svt_scores_fs: one barrier a step -----------------------------------
//
// The FS step on one lane, every lane every step. What held this step,
// when it was the planned kernel above without lengths (2.07 us/step at
// 512 lanes on an H100, PERF.md section 5):
// the observation and then the emission row it addresses, two dependent
// loads at the head of each step; dv and flags read again every step; the
// uniform candidate recomputed by every thread; and a second barrier for
// warp 0's serial patch of the special rows. Here:
//
// - a thread's rows are fixed (row i belongs to thread i % TPL), so
//   their flag bits sit in registers from the start (RCAP rows at most;
//   past that, the RCAP = 0 arm reads them each step), and the loop over
//   them is unrolled into straight-line code: the carry buffers are padded
//   to the register rows and global indices clamped, so no row is guarded
//   by a branch, and each row's loads issue ahead of its chain (guarded
//   rows compiled to one branch block a row, each waiting on its own
//   load: 0.97 against 1.28 us/step at 128 lanes);
// - the next step's symbol is read a step before it is needed, and each
//   row's emission value for step t + 1 is loaded into a register while
//   step t runs, so no load waits at a step's head (dv is read each step
//   from L1, its address known from the start: holding it too spills at
//   4 CTAs an SM, PERF.md section 5);
// - a special row is formed by its owner in the same pass: its own
//   candidates (scalar ones and the column base + r_min), all of the
//   previous carry, are parked in its slot of the new carry before the
//   bulk pass, which then takes them with the diagonal pair;
// - the next step's shared column min r_min and uniform-row scalar ub
//   leave the pass as one (min, min) partial a warp, double-buffered, ub
//   from each uniform-row source's owner (its value plus its new score;
//   min is exact and f32 rounding monotone, so this is min_u(uni_val[u] +
//   v_new[uni_src[u]]) bit for bit). After the one barrier every thread
//   reduces the warps' partials itself.
//
// Every candidate is one f32 add rounded once and min is exact, so the
// result is scores_fs_plain's bit for bit (probes/emulation.py::
// scores_fs_one_barrier is this step order in torch).
//
// Shape: one lane a CTA, in one of two compile-time shapes chosen at
// launch from the lanes (fs_launch). While one wave of FS_LAT_THREADS-
// thread CTAs, with the registers the unrolled rows take (95 at n =
// 2,432, 2 CTAs an SM), holds every lane, those run: the step is latency,
// and wide lanes with short per-thread chains win (0.97 against 1.71
// us/step for the two-barrier step at 128 lanes, 1.20 against 1.78 at 256,
// on an H100). Past that, CTAs of FS_WAVE_THREADS threads held to the
// registers that let FS_WAVE_CTAS of them share an SM run (512 lanes in
// one wave on 132 SMs, no spills): 1.91-1.94 against 2.04-2.07 at 512
// lanes. 256-thread CTAs held to 4 an SM spill and run 2.09-2.33;
// emissions staged in shared memory run 2.63 (PERF.md section 5).
#define FS_LAT_THREADS 256
#define FS_WAVE_THREADS 128
#define FS_WAVE_CTAS 4

template <int TPL, int MIN_CTAS, int RCAP>
__global__ void __launch_bounds__(TPL, MIN_CTAS)
scores_fs_kernel(const FsDesc desc, const float* __restrict__ dv,
                 const unsigned char* __restrict__ flags, const float* __restrict__ em,
                 const float* __restrict__ v0, const int* __restrict__ obs,
                 float* __restrict__ out, int batch, int steps) {
  constexpr int WARPS = TPL / 32;
  static_assert(RCAP <= 32, "the row bits of a thread fit one word");
  static_assert(MAX_SPECIAL <= 64 && MAX_UNI <= 32, "the owned slots fit one word");
  constexpr int RC = RCAP > 0 ? RCAP : 1;
  extern __shared__ float carry[];  // [2][n_buf]
  __shared__ float2 red[2][WARPS];  // (r_min, ub) partials of the carry a step makes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int n = desc.n, d = desc.d;
  // the register rows run past n into padding, so no row needs a guard
  const int n_buf = RCAP > 0 ? RC * TPL : n;

  // the special rows and uniform-row sources this thread owns
  unsigned long long my_sp = 0;
  for (int s = 0; s < desc.n_special; ++s)
    if (desc.sp_row[s] % TPL == tid) my_sp |= 1ull << s;
  unsigned my_uni = 0;
  for (int u = 0; u < desc.n_uni; ++u)
    if (desc.uni_src[u] % TPL == tid) my_uni |= 1u << u;

  // row m of this thread is i = tid + m * TPL, its diagonal source
  // i - d taken mod n (a source outside [0, n) meets +inf in dv)
  int j0 = (tid - d) % n;
  if (j0 < 0) j0 += n;
  float re[RC];
  // bit m of row m: shared; special; takes the bulk pair (not special, or
  // special from the bulk candidate). Rows past n have no bit.
  unsigned sh = 0, sp = 0, keep = 0;
#pragma unroll
  for (int m = 0; m < RC; ++m) {
    const int i = tid + m * TPL;
    re[m] = 0.0f;
    if (RCAP > 0 && i < n) {
      const unsigned f = flags[i];
      sh |= ((f & ST_SHARED) ? 1u : 0u) << m;
      sp |= ((f & ST_SPECIAL) ? 1u : 0u) << m;
      keep |= ((f & ST_SPECIAL) && !(f & ST_USE_ACC) ? 0u : 1u) << m;
    }
  }

  // the incoming carry and its partials seed the first step
  float part = INFINITY, upart = INFINITY;
  for (int i = tid; i < n; i += TPL) {
    const float v = v0[(size_t)i * batch + b];
    carry[i] = v;
    if (flags[i] & ST_SHARED) part = fminf(part, v);
  }
  for (unsigned u = my_uni; u; u &= u - 1) {
    const int k = __ffs(u) - 1;
    upart = fminf(upart, desc.uni_val[k] + carry[desc.uni_src[k]]);
  }
  part = warp_min(part);
  upart = warp_min(upart);
  if (lane == 0) red[0][warp] = make_float2(part, upart);
  int o_cur = steps > 0 ? obs[b] : 0;
  int o_next = steps > 1 ? obs[(size_t)batch + b] : 0;
  if (RCAP > 0) {
#pragma unroll
    for (int m = 0; m < RC; ++m) re[m] = em[(size_t)o_cur * n + min(tid + m * TPL, n - 1)];
  }
  __syncthreads();

  float* cur = carry;
  float* nxt = carry + n_buf;
  for (int t = 0; t < steps; ++t) {
    const int o_far = t + 2 < steps ? obs[(size_t)(t + 2) * batch + b] : 0;
    const float* em_next = em + (size_t)o_next * n;
    float r_min = INFINITY, ub = INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float2 p = red[t & 1][w];
      r_min = fminf(r_min, p.x);
      ub = fminf(ub, p.y);
    }
    // the owned special rows' own candidates, parked in their new slots
    for (unsigned long long bits = my_sp; bits; bits &= bits - 1) {
      const int s = __ffsll((long long)bits) - 1;
      float p = desc.sp_rmin_base[s] + r_min;
      for (int c = desc.sp_begin[s]; c < desc.sp_begin[s + 1]; ++c)
        p = fminf(p, desc.cand_val[c] + cur[desc.cand_src[c]]);
      nxt[desc.sp_row[s]] = p;
    }
    part = INFINITY;
    upart = INFINITY;
    if (RCAP > 0) {
      // straight-line rows: indices past n are clamped (their values land
      // in the padding and reach no partial), the special rows' parked
      // values come in by select, so every row's loads can be issued
      // ahead of its chain
#pragma unroll
      for (int m = 0; m < RC; ++m) {
        const int i = tid + m * TPL, ic = min(i, n - 1);
        int j = j0 + m * TPL;
        j = min(j >= n ? j - n : j, n - 1);
        const float bulk = fminf(dv[ic] + cur[j], ub);
        float p = INFINITY;
        if ((sp >> m) & 1u) p = nxt[i];
        const float vn = re[m] + fminf(((keep >> m) & 1u) ? bulk : INFINITY, p);
        nxt[i] = vn;
        part = fminf(part, ((sh >> m) & 1u) ? vn : INFINITY);
        re[m] = em_next[ic];
      }
    } else {
      const float* em_row = em + (size_t)o_cur * n;
      for (int i = tid; i < n; i += TPL) {
        int j = i - d;
        if (j < 0) j += n;
        if (j >= n) j -= n;
        const unsigned f = flags[i];
        float a = fminf(dv[i] + cur[j], ub);
        if (f & ST_SPECIAL) {
          const float p = nxt[i];
          a = (f & ST_USE_ACC) ? fminf(a, p) : p;
        }
        const float vn = em_row[i] + a;
        nxt[i] = vn;
        if (f & ST_SHARED) part = fminf(part, vn);
      }
    }
    for (unsigned u = my_uni; u; u &= u - 1) {
      const int k = __ffs(u) - 1;
      upart = fminf(upart, desc.uni_val[k] + nxt[desc.uni_src[k]]);
    }
    part = warp_min(part);
    upart = warp_min(upart);
    if (lane == 0) red[(t & 1) ^ 1][warp] = make_float2(part, upart);
    __syncthreads();
    o_cur = o_next;
    o_next = o_far;
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int i = tid; i < n; i += TPL) out[(size_t)i * batch + b] = cur[i];
}

// The register rows of svt_scores_fs for `rows` rows a thread: the fewest
// instantiated that hold them, else 0 (the arm that reads them each step).
static int fs_rcap(int rows) {
  static const int caps[] = {4, 8, 10, 12, 16, 20, 24, 32};
  for (const int cap : caps)
    if (rows <= cap) return cap;
  return 0;
}

// One shape of svt_scores_fs for n states: its instantiation, threads a
// CTA and dynamic shared memory (two carry buffers, padded to the
// register rows).
struct FsArm {
  const void* kernel;
  int threads;
  size_t smem;
};

template <int TPL, int MIN_CTAS>
static FsArm fs_arm(int n) {
  const int rcap = fs_rcap((n + TPL - 1) / TPL);
  const void* kernel;
  switch (rcap) {
    case 4: kernel = (const void*)scores_fs_kernel<TPL, MIN_CTAS, 4>; break;
    case 8: kernel = (const void*)scores_fs_kernel<TPL, MIN_CTAS, 8>; break;
    case 10: kernel = (const void*)scores_fs_kernel<TPL, MIN_CTAS, 10>; break;
    case 12: kernel = (const void*)scores_fs_kernel<TPL, MIN_CTAS, 12>; break;
    case 16: kernel = (const void*)scores_fs_kernel<TPL, MIN_CTAS, 16>; break;
    case 20: kernel = (const void*)scores_fs_kernel<TPL, MIN_CTAS, 20>; break;
    case 24: kernel = (const void*)scores_fs_kernel<TPL, MIN_CTAS, 24>; break;
    case 32: kernel = (const void*)scores_fs_kernel<TPL, MIN_CTAS, 32>; break;
    default: kernel = (const void*)scores_fs_kernel<TPL, MIN_CTAS, 0>; break;
  }
  return {kernel, TPL, 2 * (size_t)(rcap ? rcap * TPL : n) * sizeof(float)};
}

// The shape for `batch` lanes of n states (see above), its shared memory
// opted in.
static int fs_launch(int n, int batch, FsArm* arm) {
  const FsArm lat = fs_arm<FS_LAT_THREADS, 1>(n);
  int rc = set_smem(lat.kernel, lat.smem);
  if (rc) return rc;
  int dev = 0, sms = 0, ctas = 0;
  if ((rc = (int)cudaGetDevice(&dev))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return rc;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, lat.kernel, lat.threads, lat.smem);
  if (rc) return rc;
  *arm = batch <= ctas * sms ? lat : fs_arm<FS_WAVE_THREADS, FS_WAVE_CTAS>(n);
  return set_smem(arm->kernel, arm->smem);
}

extern "C" {

int svt_desc_size(int which) {
  return which == 0 ? (int)sizeof(ScoresDesc) : (int)sizeof(FsDesc);
}

const char* svt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int svt_scores_masked(const ScoresDesc* desc, const float* dv, const float* rv, const float* cv,
                      const float* em, const float* v0, const int* obs, const int* lengths,
                      float* out, int batch, int steps, void* stream) {
  const GenArgs args{dv, rv, cv, em, v0, obs, lengths, out, nullptr, batch, steps};
  return gen_launch<false, 0>(desc, args, stream);
}

// The shape svt_scores_masked's generic arm takes for `batch` lanes of the
// operator `desc`: lanes a CTA, threads a CTA, registers a thread, resident
// CTAs an SM, and whether the operator's tables sit in shared memory.
int svt_scores_masked_shape(const ScoresDesc* desc, int batch, int* lanes_per_cta, int* threads,
                            int* regs, int* ctas_per_sm, int* staged) {
  return gen_shape<false>(desc, batch, lanes_per_cta, threads, regs, ctas_per_sm, staged);
}

// flags: the FS tables' per-state bytes, ST_SPECIAL and ST_USE_ACC included.
int svt_scores_fs(const FsDesc* desc, const float* dv, const unsigned char* flags,
                  const float* em, const float* v0, const int* obs, float* out, int batch,
                  int steps, void* stream) {
  FsArm arm;
  int rc = fs_launch(desc->n, batch, &arm);
  if (rc) return rc;
  FsDesc d = *desc;
  void* args[] = {&d, &dv, &flags, &em, &v0, &obs, &out, &batch, &steps};
  return (int)cudaLaunchKernel(arm.kernel, dim3(batch), dim3(arm.threads), args, arm.smem,
                               (cudaStream_t)stream);
}

// The planned arm of svt_scores_masked: per-lane lengths (nullptr: every
// lane takes every step).
int svt_scores_masked_planned(const FsDesc* desc, const float* dv, const unsigned char* flags,
                              const float* em, const float* v0, const int* obs,
                              const int* lengths, float* out, int batch, int steps,
                              void* stream) {
  const size_t smem = 2 * (size_t)desc->n * sizeof(float);
  int rc = set_smem((const void*)scores_planned_kernel, smem);
  if (rc) return rc;
  scores_planned_kernel<<<batch, SVT_THREADS, smem, (cudaStream_t)stream>>>(
      *desc, dv, flags, em, v0, obs, out, batch, steps, lengths);
  return (int)cudaGetLastError();
}

// The shape svt_scores_fs takes for `batch` lanes of n states: threads a
// lane (one lane a CTA), registers a thread, resident CTAs an SM.
int svt_scores_fs_shape(int n, int batch, int* threads, int* regs, int* ctas_per_sm) {
  FsArm arm;
  int rc = fs_launch(n, batch, &arm);
  if (rc) return rc;
  *threads = arm.threads;
  return occupancy_of(arm.kernel, arm.smem, regs, ctas_per_sm, arm.threads);
}

// Registers a thread and resident CTAs an SM for n states of
// svt_scores_fs in the shape of many lanes (which = 0) and of few (3), the
// generic arm of svt_scores_masked in the shape it takes for 512 lanes of
// the corpus model's operator (1) or its planned arm (2): what decides how
// many lanes one wave of CTAs holds (spec_viterbi_tpu_torch/probes/
// laneblock.py).
int svt_scores_occupancy(int which, int n, int* regs, int* ctas_per_sm) {
  const size_t smem = 2 * (size_t)n * sizeof(float);
  if (which == 0 || which == 3) {
    const FsArm arm = which == 0 ? fs_arm<FS_WAVE_THREADS, FS_WAVE_CTAS>(n) : fs_arm<FS_LAT_THREADS, 1>(n);
    return occupancy_of(arm.kernel, arm.smem, regs, ctas_per_sm, arm.threads);
  }
  if (which == 1) {
    int lanes, threads, staged;
    const ScoresDesc d = corpus_shaped_desc(n);
    return gen_shape<false>(&d, 512, &lanes, &threads, regs, ctas_per_sm, &staged);
  }
  if (which == 2) return occupancy_of((const void*)scores_planned_kernel, smem, regs, ctas_per_sm);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
