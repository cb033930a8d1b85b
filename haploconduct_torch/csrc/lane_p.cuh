// The per-lane probability of the reference's overlap verification, shared
// by the kernels of csrc/ (score_tasks.cu, join_verify.cu) and matched by
// their plain versions (ops/score.py:lane_p). Both kernels tabulate log p
// for every (q1, q2, match) below the matrix's max phred in shared memory,
// and compute a phred past the table inline with the same function, so a
// table entry equals the inline value bit for bit.

#pragma once

#include <cuda_runtime.h>

constexpr int kNCode = 4;
constexpr int kQMax = 94;  // phreds tabulated at most
// float(np.log(10.0) / 10.0): the constant of the reference's f32 body
constexpr float kLog10Over10 = 0.23025850929940458f;

// Probability that both bases were read from one haplotype, in the
// operation order of the plain version (ops/score.py:lane_p). The __f*_rn
// intrinsics keep nvcc from contracting into FMAs, so every call site
// rounds alike.
__device__ __forceinline__ float lane_p(int qa, int qb, bool match) {
  const float p1 = expf(__fmul_rn(static_cast<float>(qa), -kLog10Over10));
  const float p2 = expf(__fmul_rn(static_cast<float>(qb), -kLog10Over10));
  const float third = 1.0f / 3.0f;
  if (match) {
    return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, p1), __fsub_rn(1.0f, p2)),
                     __fmul_rn(__fmul_rn(p1, p2), third));
  }
  return __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(p1, __fsub_rn(1.0f, p2)),
                          __fmul_rn(p2, __fsub_rn(1.0f, p1))),
                third),
      __fmul_rn(2.0f / 9.0f, __fmul_rn(p1, p2)));
}

// The log-p table's side for a matrix whose largest phred is max_qual
// (>= 0), and whether a phred lies past it (then lanes test each phred and
// compute the rest inline: the kernels' kWide variant).
struct LogTable {
  int q_tab;
  bool wide;
};

inline LogTable log_table(int max_qual) {
  const bool wide = max_qual >= kQMax;
  return {wide ? kQMax : max_qual + 1, wide};
}
