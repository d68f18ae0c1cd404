// Shared by the kernels of csrc/: block shape, descriptor caps and the
// descriptor of a structured operator. ops/_build.py mirrors the caps and
// ScoresDesc field for field and checks the struct's size at load time.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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
