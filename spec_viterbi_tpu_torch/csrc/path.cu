// Exact Viterbi path kernels for Hopper (sm_90a), each with a plain C entry
// point loaded through ctypes by spec_viterbi_tpu_torch/ops/fused.py.
//
//   svt_path       replaces spec_viterbi_tpu/ops/fused_pallas.py::
//                  _make_path_kernel: the scores recurrence of
//                  svt_scores_masked, tracking (value, source) pairs, and
//                  writing the winning source of every (step, lane, state)
//                  as int16 into src[T-1, B, n]. The generic arm, for any
//                  fused-eligible operator: generic_kernel<L, C_CAP, true,
//                  0, *> of csrc/generic.cuh, the scores arm's step with pairs
//                  (L lanes a CTA, the operator in shared memory once a
//                  launch, one barrier a step, the column (min, argmin)
//                  folded from v_new, row pairs stored as 32-bit pointer
//                  pairs where n is even).
//   svt_path_planned
//                  the same function for the operators with both uniform
//                  plans (the FS class): the planned arm, below.
//   svt_backtrace  replaces spec_viterbi_tpu/ops/fused_pallas.py::
//                  _backtrace_kernel: the reverse walk through src from a
//                  boundary state, one warp a lane, staged (below).
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
// - svt_path: like svt_scores_masked, a serial loop over T steps, each
//   ending in a block barrier; the latency of that chain and, at many
//   lanes, the SM's issue rate bound it. Its one new stream is the
//   backpointers, 2 * n bytes per lane and step (4.9 KB at n = 2,432),
//   written once and far below HBM rate at these step times. Each arm keeps
//   a lane's [n] carry in shared memory for the whole sequence
//   (double-buffered) and stores each pointer row straight from the bulk
//   pass. The TPU kernel's [T, Np, B] layout would stride every 2-byte
//   store by B; here one lane's row for one step is contiguous.
// - svt_backtrace: one dependent load per step per lane (the next state is
//   the address of the next load), so latency bounds it, not bandwidth. The
//   TPU kernel picked the pointer through a one-hot min over all states
//   because a TPU has no per-lane gather; here it is one load, from a band
//   staged in shared memory ahead of the walk.

#include "generic.cuh"

// The planned arm of svt_path: the FS kernel's step (csrc/scores.cu) with
// (value, source) pairs, for operators with both uniform plans.
//
// - A bulk row takes the pair min of its diagonal candidate (i - d) and
//   the uniform rows' scalar pair (ub, us), the latter only on real rows:
//   on a padding row no candidate is finite and the pointer is 0, as the
//   generic step has it.
// - The special rows (column targets, row-plan fixes, recomputed rows) are
//   the flattened table of FsDesc; the last warp, which has the fewest
//   bulk rows, takes each one's bulk pair, scalar candidates and emission
//   before the middle barrier (they need only the previous carry), so
//   after the barrier it merges the column candidates and stores.
// - Dense column c is exact by two passes. Its shared part's value is
//   M_c = fl(base_c + m), m the min of the carry over the shared support,
//   taken from v_new at the end of the previous step as the FS kernel
//   does (f32 rounding is monotone). Its source is the LOWEST shared row i
//   with fl(base_c + cur[i]) == M_c, which is not the argmin of cur: two
//   carries 2^-12 apart near 4096 give one sum with a column base of 1.0,
//   and the oracle takes the lower row. This step's bulk pass finds it: a
//   row that matches takes a shared-memory atomicMin on the column's slot,
//   which the patch reads after the barrier. Only a row near the min can
//   match (b + x and b + m both round to M_c, so x - m <= ulp(M_c)), so a
//   row with x > fl_ru(m + max_c ulp bound) is skipped with one compare
//   and the atomics are few. While m is +inf, M_c is too and is never
//   adopted, so no row is tested. take() then merges (M_c, i_c) with the
//   column's scalar candidates under the tie rule, so the result is the
//   generic step's, bit for bit.
// - A thread takes two neighbouring rows at a time, so their two int16
//   pointers go out as one 32-bit store (n must be even), and the loop is
//   unrolled by two so the loads of one pair overlap the last's chain.
//
// The pointer format is the generic arm's: src[T-1, B, n] int16, identity
// pointers on frozen steps.
//
// What bounds it is the chain of the FS step: two barriers a step, the
// patch between them. On an H100 the generic arm of the two-barrier design
// (since replaced, csrc/generic.cuh) spent 3.2 of 8.4 us/step at 256 lanes
// in its warp-0 patch (global reads and the 8-warp pair
// merge of each column after the barrier), 2.5 in the per-row pair
// compare of the columns and 1.0 in the pointer stores. Here the pair
// stores cost nothing measurable; a per-thread column index reduced by
// redux.sync cost 0.45 us/step against the atomics, the patch on warp 0
// 0.33 against the last warp, one loop iteration at a time 0.57 against
// two (PERF.md).
template <int C_CAP>
__global__ void __launch_bounds__(SVT_THREADS)
path_planned_kernel(const FsDesc desc, const float* __restrict__ dv,
                    const unsigned char* __restrict__ flags, const float* __restrict__ em,
                    const float* __restrict__ v0, const int* __restrict__ obs,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    short* __restrict__ bp, int batch, int steps) {
  static_assert(MAX_SPECIAL <= 64, "the patch warp holds at most two special rows a lane");
  constexpr int kPatchWarp = SVT_WARPS - 1;
  extern __shared__ float carry[];  // [2][n]
  __shared__ float red[SVT_WARPS];
  __shared__ int col_src[C_CAP];  // i_c of this step, INT_MAX until a row matches
  __shared__ float shared_min;    // m of the step about to run
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int n = desc.n, d = desc.d, n_real = desc.n_real, n_col = desc.n_col;
  if (tid < C_CAP) col_src[tid] = INT_MAX;

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
  if (warp == 0) {
    const float m = warp_min(lane < SVT_WARPS ? red[lane] : INFINITY);
    if (lane == 0) shared_min = m;
  }
  __syncthreads();
  const int my_steps = lane_steps(lengths, b, steps);

  float* cur = carry;
  float* nxt = carry + n;
  for (int t = 0; t < my_steps; ++t) {
    const float* em_row = em + (size_t)obs[(size_t)t * batch + b] * n;
    short* bp_row = bp + ((size_t)t * batch + b) * n;
    // read by every thread before the middle barrier; the patch warp
    // writes the next step's after it
    const float m = shared_min;
    float ub = INFINITY;
    int us = INT_MAX;
    for (int k = 0; k < desc.n_uni; ++k)
      take(ub, us, desc.uni_val[k] + cur[desc.uni_src[k]], desc.uni_src[k]);
    auto row_pair = [&](int i, float& u, int& s) {
      u = INFINITY;
      s = INT_MAX;
      const int j = i - d;
      if (j >= 0 && j < n) take(u, s, dv[i] + cur[j], j);
      if (i < n_real) take(u, s, ub, us);
    };
    float cm[C_CAP];
    float slack = 0.0f;
#pragma unroll
    for (int c = 0; c < C_CAP; ++c) {
      cm[c] = desc.col_base[c] + m;
      if (c < n_col) slack = fmaxf(slack, ulp_bound(cm[c]));
    }
    const float near = m < INFINITY ? __fadd_ru(m, slack) : -INFINITY;

    part = INFINITY;
#pragma unroll 2
    for (int i = 2 * tid; i < n; i += 2 * SVT_THREADS) {
      float u0, u1;
      int s0, s1;
      row_pair(i, u0, s0);
      row_pair(i + 1, u1, s1);
      const float vn0 = em_row[i] + u0, vn1 = em_row[i + 1] + u1;
      nxt[i] = vn0;
      nxt[i + 1] = vn1;
      reinterpret_cast<short2*>(bp_row)[i >> 1] =
          make_short2((short)(u0 < INFINITY ? s0 : 0), (short)(u1 < INFINITY ? s1 : 0));
      const unsigned char f0 = flags[i], f1 = flags[i + 1];
      if (f0 & ST_BULK) part = fminf(part, vn0);
      if (f1 & ST_BULK) part = fminf(part, vn1);
      // the shared rows whose sum reaches M_c; the lowest wins the min
      const float x0 = cur[i], x1 = cur[i + 1];
      const bool near0 = (f0 & ST_SHARED) && x0 <= near;
      const bool near1 = (f1 & ST_SHARED) && x1 <= near;
      if (near0 || near1) {
#pragma unroll
        for (int c = 0; c < C_CAP; ++c) {
          if (c < n_col) {
            if (near0 && desc.col_base[c] + x0 == cm[c])
              atomicMin(&col_src[c], i);
            else if (near1 && desc.col_base[c] + x1 == cm[c])
              atomicMin(&col_src[c], i + 1);
          }
        }
      }
    }

    // the patch warp takes what its special rows need of the previous
    // carry now
    float pu[2], pe[2];
    int ps[2];
    if (warp == kPatchWarp) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s = lane + 32 * k;
        pu[k] = INFINITY;
        ps[k] = INT_MAX;
        pe[k] = INFINITY;
        if (s < desc.n_special) {
          const int r = desc.sp_row[s];
          if (desc.sp_flags[s] & SP_USE_ACC) row_pair(r, pu[k], ps[k]);
          for (int c = desc.sp_begin[s]; c < desc.sp_begin[s + 1]; ++c)
            take(pu[k], ps[k], desc.cand_val[c] + cur[desc.cand_src[c]], desc.cand_src[c]);
          pe[k] = em_row[r];
        }
      }
    }

    part = warp_min(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();

    if (warp == kPatchWarp) {
      int ic[C_CAP];
#pragma unroll
      for (int c = 0; c < C_CAP; ++c) ic[c] = col_src[c];
      // every lane has its i_c: reset the slots for the next step, whose
      // atomics come after the end barrier
      __syncwarp();
      if (lane < n_col) col_src[lane] = INT_MAX;
      float r_next = lane < SVT_WARPS ? red[lane] : INFINITY;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s = lane + 32 * k;
        if (s < desc.n_special) {
          const int r = desc.sp_row[s];
          float u = pu[k];
          int src = ps[k];
          const int col = desc.sp_col[s];
#pragma unroll
          for (int c = 0; c < C_CAP; ++c)
            if (c == col) take(u, src, desc.sp_rmin_base[s] + m, ic[c]);
          const float val = pe[k] + u;
          nxt[r] = val;
          bp_row[r] = (short)(u < INFINITY ? src : 0);
          if (desc.sp_flags[s] & SP_SHARED) r_next = fminf(r_next, val);
        }
      }
      r_next = warp_min(r_next);
      if (lane == 0) shared_min = r_next;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // frozen steps keep the carry and store identity pointers
  for (int t = my_steps; t < steps; ++t) {
    short2* bp_row = reinterpret_cast<short2*>(bp + ((size_t)t * batch + b) * n);
    for (int i = 2 * tid; i < n; i += 2 * SVT_THREADS) bp_row[i >> 1] = make_short2((short)i, (short)(i + 1));
  }
  for (int i = tid; i < n; i += SVT_THREADS) out[(size_t)i * batch + b] = cur[i];
}

// ---- svt_backtrace: the staged walk -----------------------------------
//
// rev[t, b] = src[t, b, rev[t + 1, b]], starting from rev[steps, b] =
// boundary[b]; rev[t, b] is lane b's state at position t.
//
// Each step is one pointer load whose address is the last load's value.
// Read from src, a tensor of gigabytes that the path kernel has just
// written, that is one HBM latency and a TLB walk a step (0.55 us on an
// H100). The walk itself cannot be shortened, but where it goes can be
// guessed: on the main path's operators a state mostly steps back by the
// diagonal or stays, and jumps now and then. So one warp walks one lane,
// and BT_AHEAD tiles of BT_TILE steps ahead of the walk it copies, for
// each step, a band of BT_BAND pointers of that step's row around the
// predicted state into a ring in shared memory (cp.async, 16 bytes a
// copy; 2 * BT_BAND + 16 bytes a step, where the bound counts 2). The prediction
// is the state at the tile's start plus the drift of the stretch just
// walked; each step also stages the 16 bytes that hold its row's state 0,
// where half the main path's jumps land. A step is then one shared-memory
// load, and the HBM latency is paid once for the copies in flight, not
// once a step.
//
// A state outside its step's band (a jump through a dense row or column,
// a dead row's 0, a drift the stretch did not show) is a miss: the warp
// reads that pointer from src itself and, while the load is in flight,
// places the bands of every step not yet walked again from there. A miss
// right after a miss that jumped (the walk is adrift, as through random
// pointers) only reads its pointer: bands placed there would miss again,
// and each placement costs the warp more than its read. The pointer read
// never depends on the bands, so the path is exact by construction; the
// bands move only where the warp waits.
// probes/emulation.py::backtrace_staged is this walk in torch, with the
// same constants (ops/_build.py passes them as -D flags) and misses.

#define BT_K SVT_BT_TILE
#define BT_W SVT_BT_BAND
#define BT_AHEAD SVT_BT_AHEAD
#define BT_SLOTS (BT_AHEAD + 1)
#define BT_CHUNKS (BT_W / 8)  // 16-byte copies a band
#define BT_ROW (BT_W + 8)     // a step's staged pointers: the band, then the hub chunk
#define BT_WARPS 2            // lanes (one a warp) a CTA
#define BT_LAST (BT_SLOTS * BT_K)  // past a warp's hub starts: its last miss's row and state
#define BT_NO_BAND (-(1 << 30))
static_assert(BT_W % 8 == 0 && BT_K <= 32 && BT_AHEAD >= 1, "backtrace tile constants");

// What every lane of a walking warp knows of the tensor: its shape, the
// lane it walks, and the 16-byte-aligned element range [lo_al, hi_al)
// the copies may read (mis: elements from src to the 16-byte boundary
// below it).
struct BtGeom {
  const short* src;
  long long lo_al, hi_al;
  int mis, batch, n, steps, b;
  bool banded;
};

__device__ __forceinline__ long long bt_align_down(long long x, int mis) { return x - ((x + mis) & 7); }

__device__ __forceinline__ void bt_copy16(short* smem_dst, const short* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void bt_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void bt_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows r_hi down to r_lo, one lane a row: the band of BT_W pointers
// around the state predicted from the anchor (state as enters row ar) and
// the drift dq / 2^16 a step, held inside the row where it can be, and the
// hub chunk, the 16 bytes that hold the row's state 0 (where the dense
// columns of the main path's operators and every dead row lead). rel and
// hub get the row-relative starts of both. The caller commits.
__device__ __forceinline__ void bt_issue(const BtGeom& g, short* ring, int* rel, int* hub, int r_hi,
                                         int r_lo, int ar, int as, int dq, int lane) {
  for (int r = r_hi - lane; r >= r_lo; r -= 32) {
    const int q = g.steps - 1 - r;
    const int at = (q / BT_K) % BT_SLOTS * BT_K + q % BT_K;
    const long long base = ((long long)r * g.batch + g.b) * g.n;
    int lo = BT_NO_BAND, hl = BT_NO_BAND;
    if (g.banded) {
      const int pred = as + (int)(((long long)dq * (ar - r) + 32768) >> 16);
      long long a = bt_align_down(base + max(pred - BT_W / 2, 0), g.mis);
      a = min(a, bt_align_down(base + g.n + 7, g.mis) - BT_W);
      a = max(g.lo_al, min(a, g.hi_al - BT_W));
      const long long h = max(g.lo_al, min(bt_align_down(base, g.mis), g.hi_al - 8));
      lo = (int)(a - base);
      hl = (int)(h - base);
      short* dst = ring + at * BT_ROW;
#pragma unroll
      for (int c = 0; c < BT_CHUNKS; ++c) bt_copy16(dst + c * 8, g.src + a + c * 8);
      bt_copy16(dst + BT_W, g.src + h);
    }
    rel[at] = lo;
    hub[at] = hl;
  }
}

// The drift of the stretch since (ref_r, ref_s), once it is
// SVT_BT_MIN_ROWS steps long, as 2^16 times the state's change a step
// (|s - ref_s| < 2^15, so the product fits 32 bits).
__device__ __forceinline__ void bt_learn(int r, int s, int ref_r, int ref_s, int& dq) {
  const int rows = ref_r - r;
  if (rows >= SVT_BT_MIN_ROWS) dq = (s - ref_s) * 65536 / rows;
}

// A miss at row r of the tile that starts at row r0 (state s enters r):
// the pointer itself, and, while it is in flight, the rows after it staged
// again from here, one group for the rest of this tile and one for each
// tile after it (end: the last row in flight). No copy is in flight to
// this tile's slot, so its rows go out with the pointer load; the tiles
// ahead wait for their first copies to land, and the warp then waits for
// this tile's rows alone, not for the tiles ahead and then this tile's
// rows in turn (0.94 against 1.04 us a step through random pointers on
// an H100, PERF.md section 5). Adrift (the
// miss before was row r + 1's and jumped), the pointer alone: the warp
// keeps its last miss's row and state after the hub starts, so the walk's
// loop carries nothing for it. Out of line, so that loop stays small;
// returns the pointer and the drift.
__device__ __noinline__ int2 bt_miss(const BtGeom g, short* ring, int* rel, int* hub, int r0, int r,
                                     int s, int end, int ref_r, int ref_s, int dq, int lane) {
  const int s_new = g.src[((long long)r * g.batch + g.b) * g.n + s];
  const int last_r = hub[BT_LAST], last_s = hub[BT_LAST + 1];
  __syncwarp();
  if (lane == 0) {
    hub[BT_LAST] = r;
    hub[BT_LAST + 1] = s;
  }
  __syncwarp();
  if (last_r == r + 1 && abs(s - last_s) > SVT_BT_JUMP) return make_int2(s_new, dq);
  bt_learn(r, s, ref_r, ref_s, dq);
  bt_issue(g, ring, rel, hub, r - 1, max(r0 - BT_K + 1, 0), r, s, dq, lane);
  bt_commit();
  bt_wait<1>();  // the copies already in flight, all to the tiles ahead
  __syncwarp();
  for (int x = 1; x <= BT_AHEAD; ++x) {
    const int top = r0 - x * BT_K;
    if (top >= end) bt_issue(g, ring, rel, hub, top, max(top - BT_K + 1, end), r, s, dq, lane);
    bt_commit();
  }
  bt_wait<BT_AHEAD>();
  __syncwarp();
  return make_int2(s_new, dq);
}

__global__ void __launch_bounds__(BT_WARPS * 32)
backtrace_kernel(const short* __restrict__ src, const int* __restrict__ boundary,
                 int* __restrict__ rev, int batch, int n, int steps) {
  __shared__ __align__(16) short ring_all[BT_WARPS][BT_SLOTS * BT_K * BT_ROW];
  __shared__ int rel_all[BT_WARPS][BT_SLOTS * BT_K];
  __shared__ int hub_all[BT_WARPS][BT_SLOTS * BT_K + 2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * BT_WARPS + warp;
  if (b >= batch) return;  // no CTA-wide barrier below
  short* ring = ring_all[warp];
  int* rel = rel_all[warp];
  int* hub = hub_all[warp];

  BtGeom g;
  g.src = src;
  g.mis = (int)(((unsigned long long)src >> 1) & 7);
  g.lo_al = bt_align_down(7, g.mis);
  g.hi_al = bt_align_down((long long)steps * batch * n, g.mis);
  g.banded = g.hi_al - BT_W >= g.lo_al;
  g.batch = batch;
  g.n = n;
  g.steps = steps;
  g.b = b;

  const int ntiles = (steps + BT_K - 1) / BT_K;
  int s = boundary[b];
  int dq = 0;                        // the drift, dq / 2^16 a step
  int ref_r = steps - 1, ref_s = s;  // where the stretch began
  if (lane == 0) hub[BT_LAST] = -2;  // no miss yet
  for (int x = 0; x < BT_AHEAD; ++x) {
    const int top = steps - 1 - x * BT_K;
    if (x < ntiles) bt_issue(g, ring, rel, hub, top, max(top - BT_K + 1, 0), ref_r, s, dq, lane);
    bt_commit();
  }
  for (int j = 0; j < ntiles; ++j) {
    const int r0 = steps - 1 - j * BT_K;
    bt_learn(r0, s, ref_r, ref_s, dq);
    ref_r = r0;
    ref_s = s;
    __syncwarp();  // every lane is past its reads of the slot refilled here
    if (j + BT_AHEAD < ntiles) {
      const int top = r0 - BT_AHEAD * BT_K;
      bt_issue(g, ring, rel, hub, top, max(top - BT_K + 1, 0), r0, s, dq, lane);
    }
    bt_commit();
    bt_wait<BT_AHEAD>();
    __syncwarp();
    const int last = min(j + BT_AHEAD, ntiles - 1);
    const int end = max(steps - 1 - last * BT_K - BT_K + 1, 0);  // the last row in flight
    const int slot = (j % BT_SLOTS) * BT_K;
    const int kmax = min(BT_K, r0 + 1);
    const short* tile = ring + slot * BT_ROW;
    // the tile's band starts in registers, off the walk's chain; a miss
    // places them again
    int band_lo[BT_K], hub_lo[BT_K];
#pragma unroll
    for (int k = 0; k < BT_K; ++k) {
      band_lo[k] = rel[slot + k];
      hub_lo[k] = hub[slot + k];
    }
    int held = 0;  // lane k keeps the state of row r0 - k
#pragma unroll
    for (int k = 0; k < BT_K; ++k) {
      if (k >= kmax) break;
      const int r = r0 - k;
      const int off = s - band_lo[k], off_hub = s - hub_lo[k];
      const bool in_band = (unsigned)off < (unsigned)BT_W;
      int s_new;
      if (in_band || (unsigned)off_hub < 8u) {
        s_new = tile[k * BT_ROW + (in_band ? off : BT_W + off_hub)];
      } else {
        const int2 m = bt_miss(g, ring, rel, hub, r0, r, s, end, ref_r, ref_s, dq, lane);
        s_new = m.x;
        dq = m.y;
#pragma unroll
        for (int q = 0; q < BT_K; ++q) {
          band_lo[q] = rel[slot + q];
          hub_lo[q] = hub[slot + q];
        }
      }
      if (abs(s_new - s) > SVT_BT_JUMP) {
        ref_r = r - 1;
        ref_s = s_new;
      }
      if (lane == k) held = s_new;
      s = s_new;
    }
    if (lane < kmax) rev[(size_t)(r0 - lane) * batch + b] = held;
  }
}

extern "C" {

int svt_path(const ScoresDesc* desc, const float* dv, const float* rv, const float* cv,
             const float* em, const float* v0, const int* obs, const int* lengths, float* out,
             short* bp, int batch, int steps, void* stream) {
  const GenArgs args{dv, rv, cv, em, v0, obs, lengths, out, bp, batch, steps};
  return gen_launch<true, 0>(desc, args, stream);
}

// The shape svt_path's generic arm takes for `batch` lanes of the operator
// `desc` (as svt_scores_masked_shape).
int svt_path_shape(const ScoresDesc* desc, int batch, int* lanes_per_cta, int* threads, int* regs,
                   int* ctas_per_sm, int* staged) {
  return gen_shape<true>(desc, batch, lanes_per_cta, threads, regs, ctas_per_sm, staged);
}

// The planned arm of svt_path; desc->n must be even.
int svt_path_planned(const FsDesc* desc, const float* dv, const unsigned char* flags,
                     const float* em, const float* v0, const int* obs, const int* lengths,
                     float* out, short* bp, int batch, int steps, void* stream) {
  if (desc->n % 2 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)desc->n * sizeof(float);
  const int c = desc->n_col;
  void (*kernel)(const FsDesc, const float*, const unsigned char*, const float*, const float*,
                 const int*, const int*, float*, short*, int, int) =
      c <= 2 ? path_planned_kernel<2> : c <= 8 ? path_planned_kernel<8> : path_planned_kernel<MAX_COL>;
  int rc = set_smem((const void*)kernel, smem);
  if (rc) return rc;
  kernel<<<batch, SVT_THREADS, smem, (cudaStream_t)stream>>>(*desc, dv, flags, em, v0, obs, lengths,
                                                              out, bp, batch, steps);
  return (int)cudaGetLastError();
}

// Registers a thread and resident CTAs an SM for n states of svt_path's
// generic arm in the shape it takes for 512 lanes of the corpus model's
// operator (which = 0) or its planned arm (1).
int svt_path_occupancy(int which, int n, int* regs, int* ctas_per_sm) {
  if (which == 0) {
    int lanes, threads, staged;
    const ScoresDesc d = corpus_shaped_desc(n);
    return gen_shape<true>(&d, 512, &lanes, &threads, regs, ctas_per_sm, &staged);
  }
  if (which != 1) return (int)cudaErrorInvalidValue;
  return occupancy_of((const void*)path_planned_kernel<2>, 2 * (size_t)n * sizeof(float), regs,
                      ctas_per_sm);
}

int svt_backtrace(const short* src, const int* boundary, int* rev, int batch, int n, int steps,
                  void* stream) {
  backtrace_kernel<<<(batch + BT_WARPS - 1) / BT_WARPS, BT_WARPS * 32, 0, (cudaStream_t)stream>>>(
      src, boundary, rev, batch, n, steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
