// svt_scores_variant: the generic arm of svt_scores_masked (csrc/generic.cuh)
// with one of its compile-time flags, for the probes' per-component cost
// breakdown (spec_viterbi_tpu_torch/ops/probes.py, probes/kernel_variants.py
// and probes/roofline.py; it replaces the B1 bodies that the TPU probes
// patch in at spec_viterbi_tpu/ops/fused_pallas.py:1323). A source of its
// own, so its instantiations compile beside csrc/scores.cu's.

#include "generic.cuh"

extern "C" {

int svt_scores_masked(const ScoresDesc* desc, const float* dv, const float* rv, const float* cv,
                      const float* em, const float* v0, const int* obs, const int* lengths,
                      float* out, int batch, int steps, void* stream);

// flags 0: svt_scores_masked itself (any column count); a flag: at most 8
// dense columns, operands bf16 under BF16_OPS.
int svt_scores_variant(int flags, const ScoresDesc* desc, const void* dv, const void* rv,
                       const void* cv, const void* em, const float* v0, const int* obs,
                       const int* lengths, float* out, int batch, int steps, void* stream) {
  if (flags == 0)
    return svt_scores_masked(desc, (const float*)dv, (const float*)rv, (const float*)cv,
                             (const float*)em, v0, obs, lengths, out, batch, steps, stream);
  if (desc->n_col > 8) return (int)cudaErrorInvalidValue;
  const GenArgs args{dv, rv, cv, em, v0, obs, lengths, out, nullptr, batch, steps};
#define SVT_VARIANT(F) \
  case F:              \
    return gen_launch<false, F>(desc, args, stream)
  switch (flags) {
    SVT_VARIANT(VF_BF16_OPS);
    SVT_VARIANT(VF_EM_STAGED);
    SVT_VARIANT(VF_NO_COLS);
    SVT_VARIANT(VF_NO_EM);
    SVT_VARIANT(VF_NO_SPECIAL);
    SVT_VARIANT(VF_SHORT_CHAIN);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_VARIANT
}

}  // extern "C"
