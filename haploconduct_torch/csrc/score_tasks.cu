// Overlap-verification scorer for Hopper (sm_90a): whole tasks in, per-task
// sums out.
//
// Replaces the Pallas TPU kernel haploconduct_tpu/ops/pallas_score.py:
// _build_kernel (its VMEM-resident `kernel` body and its HBM/DMA
// `kernel_hbm` body) together with the host work around it: the TPU design
// cut every task into 512-lane subtasks on the host (pallas_score.py:
// segment_tasks, forced by its SMEM scalar-prefetch budget) and added the
// subtask sums back on the host (haploconduct_tpu/ops/score.py:
// reduce_segments_to_tasks). Here a group of lanes does both for a task.
//
// Input: the packed matrix `comb` (R, rw) of int16 words code | qual << 3,
// rw a multiple of 8 and rows 16-byte aligned; `lens` (R,) row lengths;
// per task row_a, row_b, pos. Task t compares a = comb[row_a, pos + j]
// with b = comb[row_b, j] for j < L, L = min(len_a - pos, len_b), and
// L = 0 when pos >= len_a (ops/score.py:score_tasks_numpy). A lane is
// counted when neither base code is >= N_CODE (N or pad). Output per task:
// f64 sum of log p, int32 counted, mismatches and #(p < mismatch_thresh).
// The f32 sum runs over one 512-lane segment at a time (SEG); segment sums
// are added in f64 in segment order. RECHECK_MARGIN is pinned on exactly
// that accumulation (haploconduct_tpu/ops/score.py:199-209).
//
// Bound: bytes. Each lane of a task is one int16 word of each row, so the
// function moves the matrix, 12 B of columns and 20 B of results a task,
// and does one f32 add a counted lane: at the SAVAGE iteration-1 shape that
// is about 0.1 ms of HBM time and far less of arithmetic. What stood in the
// way of the earlier subtask kernel was work and latency per lane, and the
// host. What bounds this one is instruction issue: some 20 integer
// instructions and one shared-memory lookup a lane (PERF.md has its times
// against the bound). The design:
// - No transcendental per lane. At launch each block tabulates log p and
//   the reject flag for every (q1, q2, match) with q below q_tab (the
//   matrix's max phred + 1, at most 94: every FASTQ phred) in shared
//   memory, with lane_p, the same function that scores a lane with a
//   higher phred inline; lane_p pins its rounding (no FMA contraction), so
//   a table entry equals the inline value bit for bit. When every phred is
//   below kQMax (the wrapper reads the matrix's max on the card), that
//   test is compiled out.
// - Latency hidden: a persistent grid claims tiles of up to kTile tasks
//   from a global counter (smaller tiles when a launch holds few tasks, so
//   every resident block has work); a tile's columns are staged into
//   shared memory with cp.async while the block scores the tile before
//   it, and one pass of the block computes every task's L from them.
//   Groups of G lanes (the wrapper picks G by row width: 4 for reads, a
//   warp for contigs) claim the tile's tasks from a
//   shared counter, so tasks of 0 to 9,000 lanes in one launch balance
//   within the tile, and each group's loads for its next step are in
//   flight while it scores the current one.
// - Lanes are predicated, not branched: a lane that is not counted adds 0.
//   With mismatch_thresh <= 0 (every workflow's default) no lane can be
//   rejected, and that variant reads and reduces no reject bits.
// - 16 bytes a lane: each lane loads 8 words of each row per step. b spans
//   start at column 0 and are aligned; an a span starts at any pos, so a
//   lane loads the aligned chunk holding its first lane, takes the next
//   chunk from its right neighbour by shuffle (the group's last lane loads
//   it), and shifts the words into place in registers. No load leaves the
//   padded row.
// Tensor cores do not apply: there is no product here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_p.cuh"

namespace {

constexpr int kSeg = 512;
constexpr int kThreads = 256;
constexpr int kTile = 512;  // tasks per staged tile, at most

// the plain version's subtask stream keeps seg_len in the low 10 bits
static_assert(kSeg < 1024, "seg_len travels in 10 bits of bolen");

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint4 ld16(const int16_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Words s..s+7 of the 16 words lo ++ hi (little-endian int16 pairs), by
// selects: groups of fewer than 32 lanes share a warp with tasks of other
// shifts, and a branch on s would run its cases one after another.
__device__ __forceinline__ uint4 shift_words(int s, const uint4& lo,
                                             const uint4& hi) {
  const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = s >> 1;
  const unsigned sh = (s & 1) * 16;
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t u0 = q == 0 ? x[k] : q == 1 ? x[k + 1] : q == 2 ? x[k + 2] : x[k + 3];
    const uint32_t u1 = q == 0 ? x[k + 1] : q == 1 ? x[k + 2] : q == 2 ? x[k + 3] : x[k + 4];
    o[k] = __funnelshift_r(u0, u1, sh);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ uint4 shfl_down16(unsigned mask, const uint4& v,
                                             int width) {
  return make_uint4(__shfl_down_sync(mask, v.x, 1, width),
                    __shfl_down_sync(mask, v.y, 1, width),
                    __shfl_down_sync(mask, v.z, 1, width),
                    __shfl_down_sync(mask, v.w, 1, width));
}

// The 8 task lanes j0 + 8g .. j0 + 8g + 7 of one step: the aligned a
// chunk holding the first of them (a_base + j0 + 8g holds task lanes from
// j0 + 8g - s), the chunk after it when the group's last lane needs it
// (the others take it from their right neighbour), and the b chunk.
struct StepLoads {
  uint4 a_lo, a_next, b;
};

template <int G>
__device__ __forceinline__ StepLoads load_step(const int16_t* a_base,
                                               const int16_t* b_row, int j,
                                               int s, int L, int g) {
  StepLoads x;
  x.a_lo = x.a_next = x.b = make_uint4(0u, 0u, 0u, 0u);
  if (j - s < L) x.a_lo = ld16(a_base + j);
  if (j < L) x.b = ld16(b_row + j);
  if (g == G - 1 && s != 0 && j + 8 - s < L) x.a_next = ld16(a_base + j + 8);
  return x;
}

template <int G, bool kReject, bool kWide>
__global__ void __launch_bounds__(kThreads)
score_tasks_kernel(const int16_t* __restrict__ comb, int64_t rw,
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ row_a,
                   const int32_t* __restrict__ row_b,
                   const int32_t* __restrict__ pos, int64_t n, int tile,
                   float mismatch_thresh, int q_tab, int* __restrict__ tiles,
                   double* __restrict__ sum_log, int32_t* __restrict__ counted,
                   int32_t* __restrict__ mism, int32_t* __restrict__ rejected) {
  constexpr int kStep = G * 8;  // lanes of a task per step of the group
  constexpr int kStepsPerSeg = kSeg / kStep;
  static_assert(kSeg % kStep == 0, "a segment is whole steps");

  __shared__ int32_t s_cols[2][3][kTile];  // row_a, row_b, pos; two tiles
  __shared__ int32_t s_len[kTile];         // L of each task of the tile
  __shared__ int s_tile[2];
  __shared__ int s_claim;
  extern __shared__ float s_log[];  // [q_tab][q_tab][match], then reject bits
  const int n_ent = q_tab * q_tab * 2;
  uint32_t* s_rej = reinterpret_cast<uint32_t*>(s_log + n_ent);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid & (G - 1);
  const unsigned gmask =
      G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (lane & ~(G - 1)));
  const int64_t n_tiles = (n + tile - 1) / tile;

  auto stage = [&](int buf, int k) {
    if (k >= n_tiles) return;
    const int64_t t0 = static_cast<int64_t>(k) * tile;
    for (int i = tid; i < 3 * tile; i += kThreads) {
      const int c = i / tile;
      const int j = i - c * tile;
      if (t0 + j < n) {
        const int32_t* col = c == 0 ? row_a : (c == 1 ? row_b : pos);
        cp_async4(&s_cols[buf][c][j], col + t0 + j);
      }
    }
  };

  // claim the first tile and let its columns arrive while the table builds
  if (tid == 0) s_tile[0] = atomicAdd(tiles, 1);
  __syncthreads();
  stage(0, s_tile[0]);
  cp_async_commit();

  const int n_pad = (n_ent + 31) & ~31;
  for (int base = tid & ~31; base < n_pad; base += kThreads) {
    const int e = base + lane;
    bool rej = false;
    if (e < n_ent) {
      const float p = lane_p(e / (2 * q_tab), (e >> 1) % q_tab, e & 1);
      s_log[e] = logf(p);
      rej = p < mismatch_thresh;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, rej);
    if (lane == 0) s_rej[base >> 5] = bits;
  }
  cp_async_wait_all();
  __syncthreads();

  int cur = 0;
  while (s_tile[cur] < n_tiles) {
    const int64_t t0 = static_cast<int64_t>(s_tile[cur]) * tile;
    const int count = static_cast<int>(n - t0 < tile ? n - t0 : tile);
    for (int i = tid; i < count; i += kThreads) {
      const int p = s_cols[cur][2][i];
      const int la = lens[s_cols[cur][0][i]];
      const int lb = lens[s_cols[cur][1][i]];
      s_len[i] = p >= la ? 0 : min(la - p, lb);
    }
    if (tid == 0) {
      s_tile[cur ^ 1] = atomicAdd(tiles, 1);
      s_claim = 0;
    }
    __syncthreads();
    stage(cur ^ 1, s_tile[cur ^ 1]);
    cp_async_commit();

    for (;;) {
      int i = 0;
      if (g == 0) i = atomicAdd(&s_claim, 1);
      i = __shfl_sync(gmask, i, 0, G);
      if (i >= count) break;
      const int p = s_cols[cur][2][i];
      const int L = s_len[i];
      const int s = p & 7;
      // 64-bit offsets: rows are full int32 and contig rows are kb wide
      const int16_t* a_base = comb + s_cols[cur][0][i] * rw + (p - s);
      const int16_t* b_row = comb + s_cols[cur][1][i] * rw;

      double acc = 0.0;
      float seg = 0.0f;
      int c = 0, m = 0, r = 0, step = 0;
      StepLoads x = load_step<G>(a_base, b_row, 8 * g, s, L, g);
      for (int j0 = 0; j0 < L; j0 += kStep) {
        const int j = j0 + 8 * g;  // this lane scores task lanes j .. j + 7
        // the next step's loads are in flight while this one is scored
        StepLoads nx = x;
        if (j0 + kStep < L) nx = load_step<G>(a_base, b_row, j + kStep, s, L, g);
        const uint4 up = shfl_down16(gmask, x.a_lo, G);
        const uint4 a_hi = g == G - 1 ? x.a_next : up;
        const uint4 a_w = shift_words(s, x.a_lo, a_hi);
        const uint32_t av[4] = {a_w.x, a_w.y, a_w.z, a_w.w};
        const uint32_t bv[4] = {x.b.x, x.b.y, x.b.z, x.b.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int wa = (av[k >> 1] >> (16 * (k & 1))) & 0xffff;
          const int wb = (bv[k >> 1] >> (16 * (k & 1))) & 0xffff;
          const int qa = wa >> 3;
          const int qb = wb >> 3;
          const bool match = ((wa ^ wb) & 7) == 0;
          // both codes below N_CODE = 4: bit 2 clear in both
          static_assert(kNCode == 4, "the counted test reads bit 2 of the codes");
          const bool cm = (j + k < L) & (((wa | wb) & 4) == 0);
          float lg;
          int rej = 0;
          if (!kWide || (qa < q_tab && qb < q_tab)) {
            const int e = ((qa * q_tab + qb) << 1) | match;
            lg = s_log[e];
            if (kReject) rej = (s_rej[e >> 5] >> (e & 31)) & 1;
          } else {  // a phred above the table: the same function inline
            const float pl = lane_p(qa, qb, match);
            lg = logf(pl);
            rej = pl < mismatch_thresh;
          }
          seg += cm ? lg : 0.0f;
          c += cm;
          m += cm & !match;
          if (kReject) r += cm & rej;
        }
        if (++step == kStepsPerSeg || j0 + kStep >= L) {
          // one f32 sum per SEG lanes, added to the f64 sum in segment order
          for (int off = G / 2; off > 0; off >>= 1) {
            seg += __shfl_xor_sync(gmask, seg, off, G);
          }
          acc += static_cast<double>(seg);
          seg = 0.0f;
          step = 0;
        }
        x = nx;
      }
      for (int off = G / 2; off > 0; off >>= 1) {
        c += __shfl_xor_sync(gmask, c, off, G);
        m += __shfl_xor_sync(gmask, m, off, G);
        if (kReject) r += __shfl_xor_sync(gmask, r, off, G);
      }
      if (g == 0) {
        sum_log[t0 + i] = acc;
        counted[t0 + i] = c;
        mism[t0 + i] = m;
        rejected[t0 + i] = r;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    cur ^= 1;
  }
}

template <int G, bool kReject, bool kWide>
int launch(const int16_t* comb, int64_t rw, const int32_t* lens,
           const int32_t* row_a, const int32_t* row_b, const int32_t* pos,
           int64_t n, float mismatch_thresh, int q_tab, int* tiles,
           double* sum_log, int32_t* counted, int32_t* mism,
           int32_t* rejected, cudaStream_t stream) {
  auto* kernel = score_tasks_kernel<G, kReject, kWide>;
  const int n_ent = q_tab * q_tab * 2;
  const size_t smem = sizeof(float) * n_ent + sizeof(uint32_t) * ((n_ent + 31) / 32);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  // tasks per tile: at most kTile; about four tiles a resident block, so
  // the dynamic claims balance; but when that leaves a block fewer tasks
  // than groups, one tile a block, so that few long tasks all run at once
  constexpr int64_t kGroups = kThreads / G;
  int64_t tile = (n + 4 * slots - 1) / (4 * slots);
  if (tile < kGroups) {
    const int64_t one_each = (n + slots - 1) / slots;
    tile = one_each < kGroups ? one_each : kGroups;
  }
  tile = tile > kTile ? kTile : tile;
  const int64_t n_tiles = (n + tile - 1) / tile;
  const int64_t blocks = slots < n_tiles ? slots : n_tiles;
  // every block claims once past the last tile
  if (n_tiles + blocks >= INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if ((err = cudaMemsetAsync(tiles, 0, sizeof(int), stream)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      comb, rw, lens, row_a, row_b, pos, n, static_cast<int>(tile),
      mismatch_thresh, q_tab, tiles, sum_log, counted, mism, rejected);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const int16_t*, int64_t, const int32_t*, const int32_t*,
                         const int32_t*, const int32_t*, int64_t, float, int, int*,
                         double*, int32_t*, int32_t*, int32_t*, cudaStream_t);

// kReject: p >= 0 always, so below a threshold of 0 no lane is rejected.
// kWide: a phred of kQMax or more is present, past the table.
template <int G>
LaunchFn pick(float mismatch_thresh, bool wide) {
  if (mismatch_thresh > 0.0f) return wide ? launch<G, true, true> : launch<G, true, false>;
  return wide ? launch<G, false, true> : launch<G, false, false>;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` without
// synchronising and returns a CUDA error code (0 on success). `max_qual`
// must be the largest phred in comb (the table holds no higher one);
// `tiles` is one int of scratch; `group` is the lanes per task: 4 or 32.
extern "C" int hc_score_tasks(const void* comb, int64_t rw, const void* lens,
                              const void* row_a, const void* row_b,
                              const void* pos, int64_t n, float mismatch_thresh,
                              int max_qual, int group, void* tiles, void* sum_log,
                              void* counted, void* mism, void* rejected,
                              void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (rw % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (max_qual < 0) return static_cast<int>(cudaErrorInvalidValue);
  const LogTable tab = log_table(max_qual);
  LaunchFn f;
  switch (group) {
    case 4: f = pick<4>(mismatch_thresh, tab.wide); break;
    case 32: f = pick<32>(mismatch_thresh, tab.wide); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return f(static_cast<const int16_t*>(comb), rw,
           static_cast<const int32_t*>(lens), static_cast<const int32_t*>(row_a),
           static_cast<const int32_t*>(row_b), static_cast<const int32_t*>(pos),
           n, mismatch_thresh, tab.q_tab, static_cast<int*>(tiles),
           static_cast<double*>(sum_log), static_cast<int32_t*>(counted),
           static_cast<int32_t*>(mism), static_cast<int32_t*>(rejected),
           static_cast<cudaStream_t>(stream));
}
