// Sanitizer harness for the native data layer, adapted from
// spec_viterbi_tpu/native/src/svt_native_test.cpp to take its inputs as
// arguments.
//
// The reference gates its C++ with Valgrind memcheck; this is the modern
// equivalent: parse a well-formed model and sequence set, plus malformed
// inputs, under AddressSanitizer/UBSan. Built and run by
// spec_viterbi_tpu_torch.native.loader.run_sanitizer_check:
//
//     svt_native_asan_test MODEL.chmm STATES SEQS.ess COUNT BAD.chmm BAD.ess
//
// Exit code 0 = all checks passed.

#include <cstdint>
#include <cstdio>
#include <cstdlib>

extern "C" {
void* svt_read_hmm(const char* path);
void svt_hmm_dims(void* handle, std::int64_t* dims4);
void svt_hmm_free(void* handle);
void* svt_read_ess(const char* path);
void svt_ess_dims(void* handle, std::int64_t* dims2);
void svt_ess_free(void* handle);
}

static int failures = 0;

#define CHECK(cond, msg)                                        \
    do {                                                        \
        if (!(cond)) {                                          \
            std::fprintf(stderr, "FAIL: %s\n", msg);            \
            ++failures;                                         \
        }                                                       \
    } while (0)

int main(int argc, char** argv) {
    if (argc != 7) {
        std::fprintf(stderr,
                     "usage: %s MODEL.chmm STATES SEQS.ess COUNT BAD.chmm BAD.ess\n",
                     argv[0]);
        return 2;
    }
    const std::int64_t states = std::atoll(argv[2]);
    const std::int64_t count = std::atoll(argv[4]);

    void* h = svt_read_hmm(argv[1]);
    CHECK(h != nullptr, "the model should parse");
    if (h) {
        std::int64_t d[4];
        svt_hmm_dims(h, d);
        CHECK(d[0] == states, "the model's state count");
        svt_hmm_free(h);
    }

    void* e = svt_read_ess(argv[3]);
    CHECK(e != nullptr, "the sequence set should parse");
    if (e) {
        std::int64_t d[2];
        svt_ess_dims(e, d);
        CHECK(d[0] == count, "the sequence count");
        svt_ess_free(e);
    }

    // malformed inputs must return nullptr, never crash
    CHECK(svt_read_hmm("/nonexistent.chmm") == nullptr, "missing file");
    CHECK(svt_read_ess("/nonexistent.ess") == nullptr, "missing ess");
    CHECK(svt_read_hmm(argv[5]) == nullptr, "hostile .chmm header");
    CHECK(svt_read_ess(argv[6]) == nullptr, "hostile .ess header");

    if (failures == 0) std::puts("native sanitizer checks OK");
    return failures == 0 ? 0 : 1;
}
