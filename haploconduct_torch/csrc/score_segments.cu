// Overlap-verification scorer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel haploconduct_tpu/ops/pallas_score.py:
// _build_kernel (both its VMEM-resident `kernel` body and its HBM/DMA
// `kernel_hbm` body: on the GPU global memory is the only path, so one
// kernel serves every matrix size).
//
// Input: the packed read matrix `comb` (R, rw) of int16 words
// code | qual << 3, and a stream of SEG=512-lane subtasks
// (rowa, rowb, posa, bolen) with bolen = k << 10 | seg_len. Subtask t
// compares a = comb[rowa, posa + j] with b = comb[rowb, k * SEG + j] for
// j < seg_len. Output per subtask: f32 sum of log p over counted lanes,
// and int32 counted, mismatches and #(p < mismatch_thresh). A lane is
// counted when neither base code is >= N_CODE (N or pad).
//
// Bound: gather bytes, not math. The TPU kernel found a math-free variant
// within 5% of the full one (pallas_score.py:31-33). Design: one warp per
// subtask; lane j reads word j, so a warp reads 64 contiguous bytes per
// side per step and the loads coalesce. Lanes at or beyond seg_len are
// never loaded, so rows need no slack columns.
//
// Each subtask keeps its own f32 sum over at most SEG lanes; subtasks of
// one task are summed on the host in f64. RECHECK_MARGIN is pinned on
// exactly that bound (haploconduct_tpu/ops/score.py:199-209).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 512;
constexpr int kNCode = 4;
constexpr int kWarpsPerBlock = 8;
// float(np.log(10.0) / 10.0): the constant of the reference's f32 body
constexpr float kLog10Over10 = 0.23025850929940458f;

static_assert(kSeg < 1024, "seg_len travels in the low 10 bits of bolen");

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
score_segments_kernel(const int16_t* __restrict__ comb, int64_t rw,
                      const int32_t* __restrict__ rowa,
                      const int32_t* __restrict__ rowb,
                      const int32_t* __restrict__ posa,
                      const int32_t* __restrict__ bolen,
                      int64_t n_sub, float mismatch_thresh,
                      float* __restrict__ sum_log,
                      int32_t* __restrict__ counted,
                      int32_t* __restrict__ mism,
                      int32_t* __restrict__ rejected) {
  const int lane = threadIdx.x & 31;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= n_sub) return;  // t is uniform across the warp

  const int32_t bl = bolen[t];
  const int64_t k = bl >> 10;
  const int seg_len = bl & 1023;
  // 64-bit offsets: rows are full int32 and contig rows are kb wide
  const int16_t* a = comb + static_cast<int64_t>(rowa[t]) * rw + posa[t];
  const int16_t* b = comb + static_cast<int64_t>(rowb[t]) * rw + k * kSeg;

  float s = 0.0f;
  int c = 0, m = 0, r = 0;
  for (int j = lane; j < seg_len; j += 32) {
    const int aw = a[j];
    const int bw = b[j];
    const int ac = aw & 7;
    const int bc = bw & 7;
    if (ac >= kNCode || bc >= kNCode) continue;
    const float p1 = expf(static_cast<float>(aw >> 3) * -kLog10Over10);
    const float p2 = expf(static_cast<float>(bw >> 3) * -kLog10Over10);
    float p;
    if (ac == bc) {
      p = (1.0f - p1) * (1.0f - p2) + (p1 * p2) * (1.0f / 3.0f);
    } else {
      p = (p1 * (1.0f - p2) + p2 * (1.0f - p1)) * (1.0f / 3.0f) +
          (2.0f / 9.0f) * (p1 * p2);
      ++m;
    }
    s += logf(p);
    ++c;
    r += (p < mismatch_thresh);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
    m += __shfl_down_sync(0xffffffffu, m, off);
    r += __shfl_down_sync(0xffffffffu, r, off);
  }
  if (lane == 0) {
    sum_log[t] = s;
    counted[t] = c;
    mism[t] = m;
    rejected[t] = r;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int hc_score_segments(const void* comb, int64_t rw,
                                 const void* rowa, const void* rowb,
                                 const void* posa, const void* bolen,
                                 int64_t n_sub, float mismatch_thresh,
                                 void* sum_log, void* counted, void* mism,
                                 void* rejected, void* stream) {
  if (n_sub <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n_sub + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  score_segments_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                          0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(comb), rw,
      static_cast<const int32_t*>(rowa), static_cast<const int32_t*>(rowb),
      static_cast<const int32_t*>(posa), static_cast<const int32_t*>(bolen),
      n_sub, mismatch_thresh, static_cast<float*>(sum_log),
      static_cast<int32_t*>(counted), static_cast<int32_t*>(mism),
      static_cast<int32_t*>(rejected));
  return static_cast<int>(cudaGetLastError());
}
