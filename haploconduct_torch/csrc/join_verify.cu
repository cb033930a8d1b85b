// Fused k-mer join + diagonal verification for Hopper (sm_90a): every
// (query k-mer, slot) candidate diagonal of a shard of query rows scored in
// one launch, with the count of slots above the edge threshold.
//
// Replaces the device program of haploconduct_tpu/parallel/mesh.py:
// sharded_pipeline_fn (its `step`, :404-491), which the reference wrote in
// jnp for XLA, not in Pallas. There, each of the `expand` slots gathers
// (R * NK, W) rows of codes and quals per operand and scores them as dense
// arrays: at the SAVAGE envelope patch (88,928 rows of 150, NK = 138) one
// such f32 array is about 7 GB, and every slot needs several. Here nothing
// per lane is written to device memory.
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
// of slots with score > edge_threshold, duplicates included (one int atomic
// a block, so the count does not depend on the order blocks finish in).
//
// Bound: bytes. The function reads the matrix, 8 B of table and 8 B of
// left/count a query and writes 4 B a slot: about 0.6 GB and 0.18 ms of
// HBM time at the envelope patch. The table entries a query gathers come in
// 32-byte sectors at random places, so the bytes the card really moves are
// nearer 2 GB. What kept the first kernel (a group of 8 lanes a slot, slots
// by a grid stride) at 1% of the bound was repeated work: a slot's score
// depends only on its diagonal (r, rb, shift), and consecutive k-mers of a
// row along a true overlap land on the same partner at the same shift, so
// at the envelope patch 48.1M valid slots hold only 1.59M distinct
// diagonals (5.03G lanes scored where 0.14G are distinct), and a row's
// slots were spread over many blocks. The design:
// - A block takes one query row at a time (a persistent grid walks the
//   rows) and works through its slots, which are contiguous in the output,
//   in tiles of kTileSlots (2,048: one tile a row at the envelope patch,
//   NK * expand = 1,104; eight at 2 kb contigs). Rows up to kRowCap words
//   are staged in shared memory once, the a side of every diagonal of the
//   row; wider ones are read from device memory.
// - Each thread finds kPer slots of the tile: their left and count, then
//   the table entries of the slots below count, each round of loads in
//   flight together; a valid slot becomes the key rb * nk + shift (< R * nk
//   < 2^31, which the wrapper checks).
// - The keys go into an open-addressing hash table in shared memory
//   (atomicCAS, linear probing, twice as many entries as slots), which
//   lists each distinct diagonal once and gives every slot its entry.
//   Duplicates across tiles of one row stay: they cost work, never a
//   different score.
// - A group of kGroup lanes scores each distinct diagonal, lane g summing
//   lanes j = g (mod kGroup) of the diagonal in order, kUnroll words of
//   each row in flight per lane, the b side loaded before its length is
//   known; the f32 sums are reduced by a fixed butterfly of shuffles. A
//   diagonal's score depends on nothing but the diagonal, so it is the
//   same whichever slot, tile, block, shard or launch asked for it, and
//   any sharding gives one device's scores bit for bit. log p comes from a
//   shared-memory table of every (q1, q2, match) built at launch by lane_p
//   (lane_p.cuh, shared with score_tasks.cu), or inline for a phred past
//   the table (kWide), so a table entry equals the inline value bit for
//   bit.
// - The tile's scores are written in slot order, coalesced; invalid slots
//   get 0.
// On an H100 80GB HBM3 at 700 W this takes 1.4 ms at the envelope patch
// (PERF.md), against 19 ms for the first kernel. The gathers and writes
// alone take 0.7 ms; the rest is the hashing and scoring of each tile
// between barriers, which at five resident blocks an SM (48 registers,
// 38 KB of shared memory) the other blocks' loads do not fully hide.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_p.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;                   // lanes that score one diagonal
constexpr int kGroups = kThreads / kGroup;
constexpr int kUnroll = 8;                   // words of each row a lane loads at once
constexpr int kTileSlots = 2048;             // slots of a row taken together
constexpr int kPer = kTileSlots / kThreads;  // slots a thread finds a tile
constexpr int kHashBits = 12;
constexpr int kHash = 1 << kHashBits;        // hash entries: load <= 1/2
constexpr int kRowCap = 4096;                // widest row staged, in words
constexpr int kEmpty = -1;
static_assert(kHash >= 2 * kTileSlots, "the hash table must hold every slot");
static_assert(kTileSlots <= 32768, "entries are listed as int16");

__device__ __forceinline__ int hash_entry(int key) {
  return static_cast<int>((static_cast<uint32_t>(key) * 2654435761u) >>
                          (32 - kHashBits));
}

// Shared memory beyond the log table: the hash keys (a scored entry holds
// its score's bits), each slot's entry, the list of distinct entries and
// the staged row.
size_t smem_bytes(int q_tab, bool staged, int64_t rw) {
  return sizeof(float) * q_tab * q_tab * 2 + sizeof(int) * kHash +
         sizeof(int16_t) * 2 * kTileSlots +
         (staged ? sizeof(int16_t) * static_cast<size_t>(rw) : 0);
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
join_verify_kernel(const int16_t* __restrict__ comb, int64_t rw,
                   const int32_t* __restrict__ lens,
                   const int32_t* __restrict__ t_rid,
                   const int32_t* __restrict__ t_pos,
                   const int32_t* __restrict__ left,
                   const int32_t* __restrict__ count, int n_rows, int row0,
                   int nk, int expand, int min_overlap_len,
                   float edge_threshold, int q_tab, bool staged,
                   float* __restrict__ scores, int* __restrict__ n_edges) {
  extern __shared__ float s_log[];  // [q_tab][q_tab][match]
  const int n_ent = q_tab * q_tab * 2;
  int* s_key = reinterpret_cast<int*>(s_log + n_ent);
  int16_t* s_slot = reinterpret_cast<int16_t*>(s_key + kHash);
  int16_t* s_list = s_slot + kTileSlots;
  int16_t* s_row = s_list + kTileSlots;
  __shared__ int s_n, s_edges;
  for (int e = threadIdx.x; e < n_ent; e += kThreads) {
    s_log[e] = logf(lane_p(e / (2 * q_tab), (e >> 1) % q_tab, e & 1));
  }
  if (threadIdx.x == 0) s_edges = 0;

  const int tid = threadIdx.x;
  const int g = tid & (kGroup - 1);
  const int grp = tid / kGroup;
  const unsigned gmask = ((kGroup == 32 ? 0u : 1u << kGroup) - 1u)
                         << ((tid & 31) & ~(kGroup - 1));
  const int row_slots = nk * expand;  // < 2^31: the wrapper checks
  int edges = 0;
  for (int qr = blockIdx.x; qr < n_rows; qr += gridDim.x) {
    const int r = row0 + qr;
    const int len_r = lens[r];
    const int16_t* a_base = staged ? s_row : comb + static_cast<int64_t>(r) * rw;
    const int32_t* left_r = left + static_cast<int64_t>(qr) * nk;
    const int32_t* count_r = count + static_cast<int64_t>(qr) * nk;
    for (int t0 = 0; t0 < row_slots; t0 += kTileSlots) {
      const int tile_n = min(kTileSlots, row_slots - t0);
      // A: an empty hash table, the row staged on its first tile, and the
      // keys of this thread's slots, every load in flight together
      for (int e = tid; e < kHash; e += kThreads) s_key[e] = kEmpty;
      if (tid == 0) s_n = 0;
      if (staged && t0 == 0) {
        const int16_t* src = comb + static_cast<int64_t>(r) * rw;
        for (int w = tid; w < rw; w += kThreads) s_row[w] = src[w];
      }
      // (p, slot d of the k-mer at p) of slot s: s = p * expand + d
      int p[kPer], cnt[kPer], lft[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int s = i * kThreads + tid;
        p[i] = (t0 + s) / expand;
        cnt[i] = s < tile_n ? count_r[p[i]] : 0;
        lft[i] = s < tile_n ? left_r[p[i]] : 0;
      }
      int rid[kPer], tpos[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = t0 + i * kThreads + tid - p[i] * expand;
        const bool found = d < cnt[i];
        const int t = found ? lft[i] + d : 0;  // < T
        rid[i] = found ? t_rid[t] : kEmpty;
        tpos[i] = found ? t_pos[t] : 0;
      }
      int key[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int shift = p[i] - tpos[i];
        key[i] = rid[i] != kEmpty && rid[i] != r && shift >= 0 ? rid[i] * nk + shift
                                                               : kEmpty;
      }
      __syncthreads();
      // B: each distinct key listed once; each slot given its entry
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        int h = kEmpty;
        if (key[i] != kEmpty) {
          h = hash_entry(key[i]);
          for (;;) {
            const int prev = atomicCAS(&s_key[h], kEmpty, key[i]);
            if (prev == kEmpty) {
              s_list[atomicAdd(&s_n, 1)] = static_cast<int16_t>(h);
              break;
            }
            if (prev == key[i]) break;
            h = (h + 1) & (kHash - 1);
          }
        }
        s_slot[i * kThreads + tid] = static_cast<int16_t>(h);
      }
      __syncthreads();
      // C: a group a distinct diagonal; its score replaces its key
      const int n_diag = s_n;
      for (int i = grp; i < n_diag; i += kGroups) {
        const int h = s_list[i];
        const int k = s_key[h];
        const int rb = k / nk;
        const int shift = k - rb * nk;
        const int16_t* a_row = a_base + shift;
        const int16_t* b_row = comb + static_cast<int64_t>(rb) * rw;
        // words are loaded up to the a side's end, which lies in both
        // rows, before the b side's length is known
        const int len_a = len_r - shift;
        const int len_b = lens[rb];
        float sum = 0.0f;
        int c = 0;
        for (int j0 = g; j0 < len_a; j0 += kGroup * kUnroll) {
          int wa[kUnroll], wb[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = j0 + u * kGroup;
            wa[u] = j < len_a ? a_row[j] : kNCode;
            wb[u] = j < len_a ? b_row[j] : kNCode;
          }
          const int L = min(len_a, len_b);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            // both codes below N_CODE = 4: bit 2 clear in both
            static_assert(kNCode == 4, "the counted test reads bit 2 of the codes");
            if (j0 + u * kGroup < L && ((wa[u] | wb[u]) & 4) == 0) {
              const int qa = wa[u] >> 3;
              const int qb = wb[u] >> 3;
              const bool match = ((wa[u] ^ wb[u]) & 7) == 0;
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
        }
        for (int off = kGroup / 2; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(gmask, sum, off, kGroup);
          c += __shfl_xor_sync(gmask, c, off, kGroup);
        }
        const float score =
            c >= min_overlap_len ? expf(sum / static_cast<float>(c > 1 ? c : 1)) : 0.0f;
        if (g == 0) s_key[h] = __float_as_int(score);
      }
      __syncthreads();
      // D: every slot's score in slot order
      float* out = scores + static_cast<int64_t>(qr) * row_slots + t0;
      for (int s = tid; s < tile_n; s += kThreads) {
        const int h = s_slot[s];
        const float score = h >= 0 ? __int_as_float(s_key[h]) : 0.0f;
        out[s] = score;
        edges += score > edge_threshold;
      }
      __syncthreads();
    }
  }
  if (edges) atomicAdd(&s_edges, edges);
  __syncthreads();
  if (threadIdx.x == 0 && s_edges) atomicAdd(n_edges, s_edges);
}

template <bool kWide>
int launch(const int16_t* comb, int64_t rw, const int32_t* lens,
           const int32_t* t_rid, const int32_t* t_pos, const int32_t* left,
           const int32_t* count, int n_rows, int row0, int nk, int expand,
           int min_overlap_len, float edge_threshold, int q_tab,
           float* scores, int* n_edges, cudaStream_t stream) {
  auto* kernel = join_verify_kernel<kWide>;
  const bool staged = rw <= kRowCap;
  const size_t smem = smem_bytes(q_tab, staged, rw);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a resident grid that walks the rows, no larger than there are rows
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = resident < n_rows ? resident : n_rows;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      comb, rw, lens, t_rid, t_pos, left, count, n_rows, row0, nk, expand,
      min_overlap_len, edge_threshold, q_tab, staged, scores, n_edges);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` without
// synchronising and returns a CUDA error code (0 on success). The queries
// are whole rows (n_query a multiple of nk); R * nk and nk * expand stay
// below 2^31. `max_qual` must be the largest phred in comb (the table
// holds no higher one); `n_edges` is one int the caller zeroed.
extern "C" int hc_join_verify(const void* comb, int64_t rw, const void* lens,
                              const void* t_rid, const void* t_pos,
                              const void* left, const void* count,
                              int64_t n_query, int row0, int nk, int expand,
                              int min_overlap_len, float edge_threshold,
                              int max_qual, void* scores, void* n_edges,
                              void* stream) {
  if (n_query <= 0 || expand <= 0) return static_cast<int>(cudaSuccess);
  if (nk <= 0 || max_qual < 0 || n_query % nk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LogTable tab = log_table(max_qual);
  return (tab.wide ? launch<true> : launch<false>)(
      static_cast<const int16_t*>(comb), rw, static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(t_rid), static_cast<const int32_t*>(t_pos),
      static_cast<const int32_t*>(left), static_cast<const int32_t*>(count),
      static_cast<int>(n_query / nk), row0, nk, expand, min_overlap_len,
      edge_threshold, tab.q_tab, static_cast<float*>(scores),
      static_cast<int*>(n_edges), static_cast<cudaStream_t>(stream));
}
