// The MoE route's capacity positions for NVIDIA Hopper, sm_90a.
//
// Replaces no Pallas kernel: the reference's `_moe_route`
// (src/repro/models/layers.py) counts the positions with a `jnp.cumsum`
// over a one-hot, and the port's plain form (../ref.py) does the same with
// `torch.cumsum` over a (K N, E) int64 one-hot, which PyTorch scans one
// column a thread, K N dependent loads each (30-39 ms a layer at
// nemotron-3-nano-30b-a3b's prefill). The function: every choice
// i = k N + n of the k-major order, with expert e = ids[n, k], gets
//
//     pos[n, k] = #{ j < i : the expert of choice j is e }
//
// its queue position within its expert, and, where asked, counts[k, e] =
// the choices of expert e among those of rank k.
//
// Layout: ids and pos (N, K) int64, contiguous (the router's top-k);
// counts (K, E) int64, zeroed by the caller. E <= MAX_E = 1024 and
// K N < 2^31. An id outside [0, E) gets position -1 and counts nowhere.
//
// What bounds it on the H100: 16 bytes a choice, the id read and the
// position written: 1.6 MB at Nemotron's prefill (98,304 choices, E 128),
// 0.5 us at 3.35 TB/s. Launch latency, a few us, is the real floor, so the
// design spends its effort on few launches and short dependent chains:
//
// - The choices go in tiles of TILE = 1,024: 8 warps, each 4 rounds of 32
//   consecutive choices. A block takes `span` consecutive choices, a
//   whole number of tiles, at most MAX_BLOCKS blocks in all.
// - Launch 1 (only where there is more than one block): each block counts
//   its span's choices by expert (warp-aggregated shared-memory atomics;
//   a count does not depend on their order) into hist[block][e].
// - Launch 2: each block sums the earlier blocks' hist rows into its
//   running count by expert, then walks its tiles. Within a round, a
//   lane's rank among the lanes of its warp with the same expert is
//   __popc(__match_any_sync(e) & lanes below); the warp keeps its own
//   count by expert over its rounds (its lowest lane of each expert adds).
//   After a barrier, a choice's position is the running count, plus the
//   earlier warps' counts in the tile, plus its warp's count before its
//   round, plus its rank in the round; then the warps' counts fold into
//   the running count. No position depends on the order of atomics.
// - At decode (12 choices) there is one block and launch 1 is skipped.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROUNDS = 4;                   // rounds of 32 choices a warp
constexpr int TILE = THREADS * ROUNDS;      // choices a tile
constexpr int MAX_E = 1024;                 // experts
constexpr int MAX_BLOCKS = 264;             // two a SM

struct Route {
  const int64_t* ids;   // (N, K)
  int64_t* pos;         // (N, K)
  int64_t* counts;      // (K, E) or null
  int* hist;            // (blocks, E) or null (one block)
  int N, K, E;
  int64_t total;        // K N
  int64_t span;         // choices a block, a multiple of TILE
};

// Choice i's expert, or -1 past the end or for an id outside [0, E); and
// its element n K + k of ids and pos.
__device__ __forceinline__ int expert_of(const Route& r, int64_t i,
                                         int64_t& at) {
  if (i >= r.total) {
    at = -1;
    return -1;
  }
  const int c = static_cast<int>(i);  // i < K N < 2^31
  const int k = c / r.N;
  at = static_cast<int64_t>(c - k * r.N) * r.K + k;
  const int64_t e = r.ids[at];
  return (e >= 0 && e < r.E) ? static_cast<int>(e) : -1;
}

// (k, e) -> its entry of counts, -1 for no expert: lanes that share one
// add their number once, from the lowest of them.
__device__ __forceinline__ void add_count(const Route& r, int64_t at, int e,
                                          int lane) {
  const int key = e < 0 ? -1 : static_cast<int>(at % r.K) * r.E + e;
  const unsigned same = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && lane == __ffs(same) - 1)
    atomicAdd(reinterpret_cast<unsigned long long*>(r.counts + key),
              static_cast<unsigned long long>(__popc(same)));
}

__global__ void __launch_bounds__(THREADS) route_hist_kernel(Route r) {
  extern __shared__ int count[];  // E
  const int lane = threadIdx.x % 32;
  for (int e = threadIdx.x; e < r.E; e += THREADS) count[e] = 0;
  __syncthreads();
  const int64_t lo = blockIdx.x * r.span;
  const int64_t hi = lo + r.span < r.total ? lo + r.span : r.total;
  for (int64_t i0 = lo; i0 < hi; i0 += THREADS) {
    int64_t at;
    const int64_t i = i0 + threadIdx.x;
    const int e = i < hi ? expert_of(r, i, at) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && lane == __ffs(same) - 1) atomicAdd(&count[e], __popc(same));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < r.E; e += THREADS)
    r.hist[blockIdx.x * r.E + e] = count[e];
}

__global__ void __launch_bounds__(THREADS) route_rank_kernel(Route r) {
  extern __shared__ int smem[];
  int* run = smem;               // E: choices of each expert before the tile
  int* wcount = smem + r.E;      // WARPS x E: each warp's, in the tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  int* mine = wcount + warp * r.E;

  for (int e = threadIdx.x; e < r.E; e += THREADS) run[e] = 0;
  for (int j = threadIdx.x; j < WARPS * r.E; j += THREADS) wcount[j] = 0;
  __syncthreads();
  // the earlier blocks' choices by expert (integer sums: any order)
  const int prior = blockIdx.x * r.E;
  for (int j = threadIdx.x; j < prior; j += THREADS)
    atomicAdd(&run[j % r.E], r.hist[j]);
  __syncthreads();

  const int64_t lo = blockIdx.x * r.span;
  const int64_t hi = lo + r.span < r.total ? lo + r.span : r.total;
  for (int64_t t0 = lo; t0 < hi; t0 += TILE) {
    int e[ROUNDS], rank[ROUNDS];
    int64_t at[ROUNDS];
#pragma unroll
    for (int j = 0; j < ROUNDS; ++j) {
      const int64_t i = t0 + (warp * ROUNDS + j) * 32 + lane;
      e[j] = i < hi ? expert_of(r, i, at[j]) : -1;
      if (i >= hi) at[j] = -1;
      const unsigned same = __match_any_sync(0xffffffffu, e[j]);
      rank[j] = e[j] >= 0 ? mine[e[j]] + __popc(same & below) : -1;
      __syncwarp();
      if (e[j] >= 0 && (same & below) == 0) mine[e[j]] += __popc(same);
      __syncwarp();
      if (r.counts) add_count(r, at[j], e[j], lane);
    }
    __syncthreads();  // every warp's counts of the tile are in
#pragma unroll
    for (int j = 0; j < ROUNDS; ++j) {
      if (at[j] < 0) continue;
      int p = -1;
      if (e[j] >= 0) {
        p = run[e[j]] + rank[j];
        for (int w = 0; w < warp; ++w) p += wcount[w * r.E + e[j]];
      }
      r.pos[at[j]] = p;
    }
    __syncthreads();  // every position read the counts
    for (int x = threadIdx.x; x < r.E; x += THREADS) {
      int s = run[x];
      for (int w = 0; w < WARPS; ++w) {
        s += wcount[w * r.E + x];
        wcount[w * r.E + x] = 0;
      }
      run[x] = s;
    }
    __syncthreads();  // the running count is the next tile's
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launches were accepted. `blocks` and
// `span` are the caller's plan (ops.py): span a multiple of TILE, blocks
// <= MAX_BLOCKS spans covering the N K choices, none empty; `hist` holds
// blocks x E int32 where blocks > 1; `counts` is null or (K, E) zeroed.
int moe_route_positions(const void* ids, void* pos, void* counts, void* hist,
                        int N, int K, int E, int blocks, long long span,
                        void* stream) {
  const int64_t total = static_cast<int64_t>(N) * K;
  if (N <= 0 || K <= 0 || E <= 0 || E > MAX_E || total >= (1LL << 31) ||
      blocks <= 0 || blocks > MAX_BLOCKS || span <= 0 || span % TILE ||
      blocks * span < total || (blocks - 1) * span >= total ||
      (blocks > 1 && hist == nullptr) ||
      (counts != nullptr && static_cast<int64_t>(K) * E >= (1LL << 31)))
    return cudaErrorInvalidValue;
  Route r{static_cast<const int64_t*>(ids), static_cast<int64_t*>(pos),
          static_cast<int64_t*>(counts), static_cast<int*>(hist),
          N, K, E, total, static_cast<int64_t>(span)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks > 1) {
    route_hist_kernel<<<blocks, THREADS, E * sizeof(int), st>>>(r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  route_rank_kernel<<<blocks, THREADS, (WARPS + 1) * E * sizeof(int), st>>>(
      r);
  return cudaGetLastError();
}

const char* moe_route_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
