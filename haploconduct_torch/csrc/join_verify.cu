// Fused k-mer join + diagonal verification for Hopper (sm_90a): every
// (query k-mer, slot) candidate diagonal of a shard of query rows scored in
// one launch, with the count of slots above the edge threshold.
//
// Replaces the device program of haploconduct_tpu/parallel/mesh.py:
// sharded_pipeline_fn (its `step`, :436-480), which the reference wrote in
// jnp for XLA, not in Pallas. There, each of the `expand` slots gathers
// (R * NK, W) rows of codes and quals per operand and scores them as dense
// arrays: at the SAVAGE envelope patch (88,928 rows of 150, NK = 138) one
// such f32 array is about 7 GB, and every slot needs several. Here a group
// of kGroup lanes scores one slot straight from the packed matrix, and
// nothing per lane is written to device memory.
//
// Input: the packed matrix `comb` (R, rw) of int16 words code | qual << 3
// (ops/score.py:pack_for_device), `lens` (R,) row lengths; the sorted table
// of forward k-mers as t_rid, t_pos (T,) (ops/kmer_device.py:kmer_table);
// per query k-mer q of the shard (row row0 + q / nk, position q % nk) its
// `left` and `count` in the table (count 0 for a k-mer holding an N or
// pad; ops/join_verify.py:kmer_queries). Slot d of q is valid when
// d < count, the partner row rb = t_rid[left + d] differs from the query
// row r, and shift = p - t_pos[left + d] >= 0. It scores a = comb[r, shift
// + j] against b = comb[rb, j] for j < L = min(len[r] - shift, len[rb]),
// counting lanes where neither code is N or pad. score = exp(sum log p /
// counted) when valid and counted >= min_overlap_len, else 0. Output:
// scores (n_query * expand,) f32 in slot order, and n_edges += the number
// of slots with score > edge_threshold (one int atomic a block, so the
// count does not depend on the order blocks finish in).
//
// Bound: bytes. The function reads the matrix, 8 B of table and 8 B of
// left/count a query and writes 4 B a slot: about 0.6 GB and 0.2 ms of
// HBM time at the envelope patch, against one f32 add a counted lane
// (about 5G lanes, under 0.1 ms at the FP32 rate). This first kernel is
// simple: a group claims slots by a grid stride, loads one int16 word of
// each row a lane per step, and looks log p up in a shared-memory table of
// every (q1, q2, match) built at launch by lane_p (lane_p.cuh, shared with
// score_tasks.cu), so a table entry equals the inline value bit for bit. A
// slot is scored whole by one group, its f32 sum reduced by shuffles in a
// fixed order, so its score does not depend on the shard or the launch.
// One group size at every width: on an H100 80GB HBM3 at 700 W, 8 lanes a
// slot took 19.3 ms at the envelope patch and a warp a slot 35.7 ms
// (PERF.md; an invalid slot holds the whole group for a step). No workflow calls the step yet, so its
// speed waits for one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_p.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // lanes that score one slot
constexpr int kGroups = kThreads / kGroup;

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
join_verify_kernel(const int16_t* __restrict__ comb, int64_t rw,
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ t_rid,
                   const int32_t* __restrict__ t_pos,
                   const int32_t* __restrict__ left,
                   const int32_t* __restrict__ count, int64_t n_query,
                   int row0, int nk, int expand, int min_overlap_len,
                   float edge_threshold, int q_tab,
                   float* __restrict__ scores, int* __restrict__ n_edges) {
  extern __shared__ float s_log[];  // [q_tab][q_tab][match]
  __shared__ int s_edges;
  const int n_ent = q_tab * q_tab * 2;
  for (int e = threadIdx.x; e < n_ent; e += kThreads) {
    s_log[e] = logf(lane_p(e / (2 * q_tab), (e >> 1) % q_tab, e & 1));
  }
  if (threadIdx.x == 0) s_edges = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x & (kGroup - 1);
  const unsigned gmask = ((1u << kGroup) - 1u) << (lane & ~(kGroup - 1));
  const int64_t n_slots = n_query * expand;
  const int64_t n_groups = static_cast<int64_t>(gridDim.x) * kGroups;
  int edges = 0;
  for (int64_t s = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kGroup;
       s < n_slots; s += n_groups) {
    // every lane of a group holds the same slot, so the branches below are
    // taken by the whole group together
    const int64_t q = s / expand;
    const int d = static_cast<int>(s - q * expand);
    const int64_t qr = q / nk;
    const int r = row0 + static_cast<int>(qr);
    const int p = static_cast<int>(q - qr * nk);
    float score = 0.0f;
    if (d < count[q]) {
      const int64_t t = static_cast<int64_t>(left[q]) + d;  // < T: d < count
      const int rb = t_rid[t];
      const int shift = p - t_pos[t];
      if (rb != r && shift >= 0) {
        const int L = min(lens[r] - shift, lens[rb]);
        const int16_t* a_row = comb + static_cast<int64_t>(r) * rw + shift;
        const int16_t* b_row = comb + static_cast<int64_t>(rb) * rw;
        float sum = 0.0f;
        int c = 0;
        for (int j = g; j < L; j += kGroup) {
          const int wa = a_row[j];
          const int wb = b_row[j];
          // both codes below N_CODE = 4: bit 2 clear in both
          static_assert(kNCode == 4, "the counted test reads bit 2 of the codes");
          if (((wa | wb) & 4) == 0) {
            const int qa = wa >> 3;
            const int qb = wb >> 3;
            const bool match = ((wa ^ wb) & 7) == 0;
            float lg;
            if (!kWide || (qa < q_tab && qb < q_tab)) {
              lg = s_log[((qa * q_tab + qb) << 1) | match];
            } else {  // a phred above the table: the same function inline
              lg = logf(lane_p(qa, qb, match));
            }
            sum += lg;
            ++c;
          }
        }
        for (int off = kGroup / 2; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(gmask, sum, off, kGroup);
          c += __shfl_xor_sync(gmask, c, off, kGroup);
        }
        if (c >= min_overlap_len) {
          score = expf(sum / static_cast<float>(c > 1 ? c : 1));
        }
      }
    }
    if (g == 0) {
      scores[s] = score;
      edges += score > edge_threshold;
    }
  }
  if (edges) atomicAdd(&s_edges, edges);
  __syncthreads();
  if (threadIdx.x == 0 && s_edges) atomicAdd(n_edges, s_edges);
}

template <bool kWide>
int launch(const int16_t* comb, int64_t rw, const int32_t* lens,
           const int32_t* t_rid, const int32_t* t_pos, const int32_t* left,
           const int32_t* count, int64_t n_query, int row0, int nk, int expand,
           int min_overlap_len, float edge_threshold, int q_tab,
           float* scores, int* n_edges, cudaStream_t stream) {
  auto* kernel = join_verify_kernel<kWide>;
  const size_t smem = sizeof(float) * q_tab * q_tab * 2;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a resident grid that strides over the slots, no larger than they need
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t needed = (n_query * expand + kGroups - 1) / kGroups;
  const int64_t blocks = resident < needed ? resident : needed;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      comb, rw, lens, t_rid, t_pos, left, count, n_query, row0, nk, expand,
      min_overlap_len, edge_threshold, q_tab, scores, n_edges);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` without
// synchronising and returns a CUDA error code (0 on success). `max_qual`
// must be the largest phred in comb (the table holds no higher one);
// `n_edges` is one int the caller zeroed.
extern "C" int hc_join_verify(const void* comb, int64_t rw, const void* lens,
                              const void* t_rid, const void* t_pos,
                              const void* left, const void* count,
                              int64_t n_query, int row0, int nk, int expand,
                              int min_overlap_len, float edge_threshold,
                              int max_qual, void* scores, void* n_edges,
                              void* stream) {
  if (n_query <= 0 || expand <= 0) return static_cast<int>(cudaSuccess);
  if (nk <= 0 || max_qual < 0) return static_cast<int>(cudaErrorInvalidValue);
  const LogTable tab = log_table(max_qual);
  return (tab.wide ? launch<true> : launch<false>)(
      static_cast<const int16_t*>(comb), rw, static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(t_rid), static_cast<const int32_t*>(t_pos),
      static_cast<const int32_t*>(left), static_cast<const int32_t*>(count),
      n_query, row0, nk, expand, min_overlap_len, edge_threshold, tab.q_tab,
      static_cast<float*>(scores), static_cast<int*>(n_edges),
      static_cast<cudaStream_t>(stream));
}
