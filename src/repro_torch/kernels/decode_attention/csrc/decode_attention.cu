// Single-token GQA decode attention (flash-decoding) for NVIDIA Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel `decode_attention_fwd`
// (src/repro/kernels/decode_attention/decode_attention.py). Same function:
// one query token per sequence against a W-slot KV cache, an additive
// float32 bias (B, W) as the ring-validity mask, softmax in float32, scale
// 1/sqrt(d) of the true d.
//
// Layout: q (B,1,H,d), k/v (B,W,K,d), bias (B,W) float32, out (B,1,H,d),
// all contiguous, read in place. q and out are float32 or bfloat16; k/v are
// q's type or bfloat16 (a bfloat16 cache under a float32 model). W and d
// are not padded; the ragged W edge is masked here.
//
// What bounds it on the H100: bytes. At h2o-danube's decode shape (B=4,
// W=4096, K=8, d=80, bf16) the K/V cache is 42 MB per layer: 12.5 us at
// the 3.35 TB/s data-sheet rate (700 W limit; computed, not measured),
// against 1.7e8 FLOP, 2.5 us at the float32 CUDA-core peak.
//
// Design. The TPU grid (B, K, n_w) walks W in order inside one program per
// (b, kv head); here W is split across the blocks of a thread-block
// cluster, one cluster per (b, kv head), and the G = H/K query heads of a
// kv group ride in one block, so each K/V byte is read once.
//
// - Split: the wrapper cuts W into chunks of CH slots and gives each block
//   of the cluster a whole number of chunks, so that (B * K * splits)
//   blocks, two an SM, fill the card in one wave (at most MAX_SPLITS a
//   cluster, the portable cluster size).
// - Ring: a block walks its range in tiles of TS slots (TS <= CH). Each
//   thread copies 16-byte pieces of the K and V rows and the bias by
//   cp.async into a ring of STAGES stages, as the cache's type (bf16 stays
//   bf16 in shared memory), rows padded by 16 bytes so that 8 consecutive
//   rows hit distinct banks. The next tile's K and V are in flight while
//   this one computes; the ragged tail is zero-filled and masked.
// - bf16 q and cache (the serve path), `tc::decode_bf16_kernel`: each of
//   the 4 warps takes 16 slots of every 64-slot tile and keeps its own
//   online softmax over them. S = Q K^T by mma.sync (16 head rows, those
//   past G zero; q's fragments stay in registers), P V by mma.sync with p
//   split into two bf16 parts (hi + lo, as the flash kernel splits it) so
//   that p keeps float32 precision. No block barrier but the ring's.
// - float32 q (either cache type), `decode_kernel`: CUDA cores. One (head,
//   slot) pair a thread at a time for the scores (a warp on 32 slots of one
//   head, q broadcast from shared memory), the tile's row maximum by warp
//   shuffles, p = exp(s - m) into shared memory; P V by threads that own
//   two columns of every head and one of SG slot groups. No thread carries
//   a chain longer than a tile.
// - Merge, in the same launch: each block merges its warps' or slot
//   groups' partials into (m, l, acc) per head, then stores them through
//   distributed shared memory into the blocks that own each output; after
//   one cluster barrier each block merges its outputs in split order
//   (deterministic) from its own shared memory. A split whose slots are
//   all masked has m = -1e30 and weight exp(-1e30 - M) = 0 in the merge: it
//   adds exactly nothing.
//
// Scores, softmax and sums are float32 (products of bf16 inputs are exact
// on the tensor cores), with one rounding at the output.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::sm90;

constexpr int CH = 128;         // slots a chunk: a split is whole chunks
constexpr int MAXG = 16;        // query heads per kv head
constexpr int MAX_SPLITS = 8;   // blocks a cluster (the portable limit)
constexpr int THREADS = 256;
constexpr int STAGES = 2;

// The staged tile of a K/V type and head dim: TS_ slots, or by default as
// many as keep one stage of K and V rows under ~48 KB.
template <typename TKV, int D, int TS_ = 0>
struct Tile {
  static constexpr int ROW = D * (int)sizeof(TKV) + 16;  // padded row bytes
  static constexpr int TS =
      TS_ ? TS_ : ROW <= 192 ? 128 : ROW <= 384 ? 64 : 32;
  static constexpr int STAGE = TS * (2 * ROW + 4);        // K, V, bias
  static_assert(CH % TS == 0 && (ROW / 16) % 2 == 1, "tile layout");
};

// Floats of a block's receive buffer for the merge of D-wide heads.
template <int D>
constexpr int recv_floats() {
  return MAXG * D + MAX_SPLITS + 2 * MAX_SPLITS * MAXG;
}

// Group bucket: the head loops run to GM with the real G as a guard.
template <int D, int GM>
struct Smem {
  static constexpr int CP = D / 2;          // column pairs
  static constexpr int SG = THREADS / CP;   // slot groups of P V
  template <typename TKV>
  static constexpr size_t bytes() {
    using T = Tile<TKV, D>;
    constexpr size_t ring = (size_t)STAGES * T::STAGE;
    // the end-of-block reduction reuses the ring
    static_assert((size_t)SG * GM * D * 4 + (size_t)T::TS * GM * 4 <= ring,
                  "reduction does not fit the ring");
    return ring + 4 * ((size_t)GM * D + T::TS * GM + GM * (T::TS / 32) +
                       2 * GM + GM + 2 * GM + GM * D + recv_floats<D>());
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Two neighbouring elements widened to float.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Merges the partials (m, l, acc) of the blocks of this cluster and writes
// out[i] = acc / l for the n = G * D outputs of the kv group. Block `split`
// owns the outputs i with i % nsplit == split: every block stores its m
// and l of every head into every block's `recv`, and its acc of each
// output into the owner's (distributed shared memory); after one cluster
// barrier each block merges what it owns, in split order, from its own
// shared memory, and may leave. The kernel must have called
// cluster_arrive_relaxed() when it started.
template <typename TO>
__device__ __forceinline__ void merge_splits(const float* pm, const float* pl,
                                             const float* pacc, float* recv,
                                             TO* out, int G, int D) {
  const int split = blockIdx.x;       // the block's rank in its cluster
  const int nsplit = gridDim.x;
  const int n = G * D;
  float* rm = recv + MAXG * D + MAX_SPLITS;   // MAX_SPLITS x MAXG
  float* rl = rm + MAX_SPLITS * MAXG;          // MAX_SPLITS x MAXG
  __syncthreads();  // the block's partial is in
  cluster_wait();   // every block of the cluster has started
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    st_cluster(recv + i / nsplit * nsplit + split, i % nsplit, pacc[i]);
  for (int i = threadIdx.x; i < G * nsplit; i += blockDim.x) {
    const int g = i / nsplit;
    const int r = i - g * nsplit;
    st_cluster(rm + split * MAXG + g, r, pm[g]);
    st_cluster(rl + split * MAXG + g, r, pl[g]);
  }
  cluster_sync();
  for (int i = split + nsplit * threadIdx.x; i < n; i += nsplit * blockDim.x) {
    const int g = i / D;
    const float* ra = recv + i / nsplit * nsplit;
    float mx = kNegBig;
    for (int r = 0; r < nsplit; ++r) mx = fmaxf(mx, rm[r * MAXG + g]);
    float ls = 0.f, as = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const float w = expf(rm[r * MAXG + g] - mx);
      ls = fmaf(rl[r * MAXG + g], w, ls);
      as = fmaf(ra[r], w, as);
    }
    store(out + i, as / fmaxf(ls, 1e-30f));
  }
}

// Starts the cp.async copies of tile t of the block's slot range [s_begin,
// s_end) of (b, kv head kk): the K and V rows, zero-filled past s_end, and
// their bias, into `stage`; then commits the group (an empty one past the
// last tile, which keeps the count of groups in flight).
template <typename T, int NT, typename TKV>
__device__ __forceinline__ void copy_tile(unsigned char* stage, const TKV* k,
                                          const TKV* v, const float* bias,
                                          int t, int ntiles, int s_begin,
                                          int s_end, int b, int W, int K,
                                          int kk) {
  constexpr int NV = 16 / sizeof(TKV);       // elements in 16 bytes
  constexpr int VPR = T::ROW / 16 - 1;       // 16-byte pieces a row
  if (t < ntiles) {
    unsigned char* sK = stage;
    unsigned char* sV = sK + T::TS * T::ROW;
    float* sB = reinterpret_cast<float*>(sV + T::TS * T::ROW);
    const int w0 = s_begin + t * T::TS;
    for (int i = threadIdx.x; i < T::TS * VPR; i += NT) {
      const int r = i / VPR;
      const int c = i - r * VPR;
      const bool ok = w0 + r < s_end;
      const int64_t off =
          ok ? (((int64_t)b * W + w0 + r) * K + kk) * (VPR * NV) + c * NV
             : 0;
      cp_async16(sK + r * T::ROW + c * 16, k + off, ok);
      cp_async16(sV + r * T::ROW + c * 16, v + off, ok);
    }
    for (int r = threadIdx.x; r < T::TS; r += NT) {
      const bool ok = w0 + r < s_end;
      cp_async4(sB + r, bias + (ok ? (int64_t)b * W + w0 + r : 0), ok);
    }
  }
  cp_async_commit();
}

template <typename TQ, typename TKV, int D, int GM>
__global__ void __launch_bounds__(THREADS, GM == 4 ? 2 : 1)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ bias,
              TQ* __restrict__ out, int W, int K, int G,
              int chunks_per_split, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using T = Tile<TKV, D>;
  constexpr int TS = T::TS;
  constexpr int ROW = T::ROW;
  constexpr int NV = 16 / sizeof(TKV);     // elements in 16 bytes
  constexpr int VPR = D / NV;              // 16-byte pieces a row
  constexpr int CP = Smem<D, GM>::CP;
  constexpr int SG = Smem<D, GM>::SG;
  constexpr int WPT = TS / 32;             // warps of slots a head a tile
  constexpr int PAIRS = (TS * GM + THREADS - 1) / THREADS;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* sQ = reinterpret_cast<float*>(smem + STAGES * T::STAGE);  // GM x D
  float* sP = sQ + GM * D;            // TS x GM scores, then probabilities
  float* sRed = sP + TS * GM;         // GM x WPT tile maxima
  float* sM = sRed + GM * WPT;        // 2 x GM running max (by tile parity)
  float* sAlpha = sM + 2 * GM;        // GM rescale factors of this tile
  float* pm = sAlpha + GM;            // the block's partial: m (GM),
  float* pl = pm + GM;                //   l (GM),
  float* pacc = pl + GM;              //   acc (GM x D)
  float* recv = pacc + GM * D;        // the merge's, recv_floats<D>()

  const int split = blockIdx.x;       // the block's rank in its cluster
  const int kk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int H = K * G;
  const int s_begin = split * chunks_per_split * CH;
  const int s_end = min(W, s_begin + chunks_per_split * CH);
  const int ntiles = (s_end - s_begin + TS - 1) / TS;

  auto load_tile = [&](int t) {
    copy_tile<T, THREADS>(ring + (t % STAGES) * T::STAGE, k, v, bias, t,
                          ntiles, s_begin, s_end, b, W, K, kk);
  };

  cluster_arrive_relaxed();  // the merge waits for it
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);
  const int64_t qbase = ((int64_t)b * H + kk * G) * D;
  for (int i = tid; i < G * D; i += THREADS)
    sQ[i] = to_f32(q[qbase + i]) * scale;
  if (tid < GM) sM[tid] = kNegBig;

  float l_part[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) l_part[p] = 0.f;
  const int cp = tid % CP;      // P V: column pair
  const int sg = tid / CP;      //      slot group (idle when >= SG)
  float acc[GM][2];
#pragma unroll
  for (int g = 0; g < GM; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t is in; the stage of tile t - 1 is free
    load_tile(t + STAGES - 1);
    const unsigned char* sK = ring + (t % STAGES) * T::STAGE;
    const unsigned char* sV = sK + TS * ROW;
    const float* sB = reinterpret_cast<const float*>(sV + TS * ROW);
    const int rows = min(TS, s_end - (s_begin + t * TS));
    const float* m_old = sM + (t & 1) * GM;
    float* m_new = sM + ((t + 1) & 1) * GM;

    // scores, into sP: pair = g * TS + j, a warp on 32 slots of one head
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int pair = tid + p * THREADS;
      const int g = pair / TS;
      const int j = pair - g * TS;
      float s = kNegBig;
      if (g < G && j < rows) {
        const TKV* kr = reinterpret_cast<const TKV*>(sK + j * ROW);
        const float* qg = sQ + g * D;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int c = 0; c < VPR; ++c) {
          float kf[NV];
          load16(kr + c * NV, kf);
#pragma unroll
          for (int u = 0; u < NV; u += 4) {
            const float4 qq =
                *reinterpret_cast<const float4*>(qg + c * NV + u);
            a0 = fmaf(qq.x, kf[u], a0);
            a1 = fmaf(qq.y, kf[u + 1], a1);
            a0 = fmaf(qq.z, kf[u + 2], a0);
            a1 = fmaf(qq.w, kf[u + 3], a1);
          }
        }
        s = (a0 + a1) + sB[j];
      }
      if (g < G) sP[j * GM + g] = s;
      const float mx = warp_max(s);
      if (lane == 0 && g < G) sRed[g * WPT + j / 32] = mx;
    }
    __syncthreads();  // tile maxima in

    // probabilities against the new running max
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int pair = tid + p * THREADS;
      const int g = pair / TS;
      const int j = pair - g * TS;
      if (g < G) {
        const float mo = m_old[g];
        float mx = mo;
#pragma unroll
        for (int w = 0; w < WPT; ++w) mx = fmaxf(mx, sRed[g * WPT + w]);
        const float pr = j < rows ? expf(sP[j * GM + g] - mx) : 0.f;
        l_part[p] = fmaf(l_part[p], expf(mo - mx), pr);
        sP[j * GM + g] = pr;
      }
    }
    if (tid < G) {
      const float mo = m_old[tid];
      float mx = mo;
#pragma unroll
      for (int w = 0; w < WPT; ++w) mx = fmaxf(mx, sRed[tid * WPT + w]);
      m_new[tid] = mx;
      sAlpha[tid] = expf(mo - mx);
    }
    __syncthreads();  // probabilities and rescale factors in

    if (sg < SG) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float a = sAlpha[g];
          acc[g][0] *= a;
          acc[g][1] *= a;
        }
      }
      for (int j = sg; j < rows; j += SG) {
        const float2 vv =
            load2(reinterpret_cast<const TKV*>(sV + j * ROW) + 2 * cp);
        const float* pj = sP + j * GM;
#pragma unroll
        for (int g4 = 0; g4 < GM; g4 += 4) {
          if (g4 < G) {
            const float4 pp = *reinterpret_cast<const float4*>(pj + g4);
            acc[g4][0] = fmaf(pp.x, vv.x, acc[g4][0]);
            acc[g4][1] = fmaf(pp.x, vv.y, acc[g4][1]);
            acc[g4 + 1][0] = fmaf(pp.y, vv.x, acc[g4 + 1][0]);
            acc[g4 + 1][1] = fmaf(pp.y, vv.y, acc[g4 + 1][1]);
            acc[g4 + 2][0] = fmaf(pp.z, vv.x, acc[g4 + 2][0]);
            acc[g4 + 2][1] = fmaf(pp.z, vv.y, acc[g4 + 2][1]);
            acc[g4 + 3][0] = fmaf(pp.w, vv.x, acc[g4 + 3][0]);
            acc[g4 + 3][1] = fmaf(pp.w, vv.y, acc[g4 + 3][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every tile done: the ring is free

  // the block's partial: slot groups, then l's pairs, each in fixed order
  float* sAcc = reinterpret_cast<float*>(ring);   // SG x GM x D
  float* sL = sAcc + SG * GM * D;                 // TS x GM, pair order
  if (sg < SG) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        sAcc[(sg * GM + g) * D + 2 * cp] = acc[g][0];
        sAcc[(sg * GM + g) * D + 2 * cp + 1] = acc[g][1];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int pair = tid + p * THREADS;
    if (pair < TS * GM) sL[pair] = l_part[p];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    const int e = i - g * D;
    float a = 0.f;
    for (int s = 0; s < SG; ++s) a += sAcc[(s * GM + g) * D + e];
    pacc[g * D + e] = a;
  }
  if (tid < G) {
    float l = 0.f;
    for (int j = 0; j < TS; ++j) l += sL[tid * TS + j];
    pl[tid] = l;
    pm[tid] = sM[(ntiles & 1) * GM + tid];
  }
  merge_splits(pm, pl, pacc, recv, out + qbase, G, D);
}

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;
constexpr int TS = 16 * WARPS;      // a tile: 16 slots a warp

template <int D>
constexpr size_t smem_bytes() {
  using T = Tile<bf16, D, TS>;
  constexpr size_t ring = (size_t)STAGES * T::STAGE;
  static_assert((size_t)WARPS * MAXG * (D + 2) * 4 <= ring,
                "warp partials do not fit the ring");
  return ring + 4 * ((size_t)MAXG * (D + 2) + recv_floats<D>());
}

// bf16 q and cache on tensor cores. Each warp takes 16 slots of every tile
// and keeps its own online softmax over them: S (16 heads x 16 slots) =
// Q K^T by mma.sync m16n8k16 (q's A fragments in registers for the whole
// kernel, rows past G zero; K by ldmatrix), p = exp(s - m) in float32, and
// P V with P split into two bf16 parts, hi = bf16(p) and lo = bf16(p - hi),
// two products into one float32 accumulator (V by ldmatrix.trans), so that
// P V keeps float32 precision in p. The block's only barrier in the loop
// is the ring's. The warps' partials are merged in warp order, then the
// cluster's in split order.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 80 ? 2 : 1)
decode_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   bf16* __restrict__ out, int W, int K, int G,
                   int chunks_per_split, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using T = Tile<bf16, D, TS>;
  constexpr int ROW = T::ROW;
  constexpr int KS = D / 16;           // k steps of Q K^T
  constexpr int NT = D / 8;            // n tiles of P V

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* pm = reinterpret_cast<float*>(smem + STAGES * T::STAGE);
  float* pl = pm + MAXG;
  float* pacc = pl + MAXG;             // MAXG x D
  float* recv = pacc + MAXG * D;       // the merge's, recv_floats<D>()

  const int split = blockIdx.x;
  const int kk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;            // fragment row: head gr and gr + 8
  const int gc = lane & 3;             // fragment column pair
  const int H = K * G;
  const int s_begin = split * chunks_per_split * CH;
  const int s_end = min(W, s_begin + chunks_per_split * CH);
  const int ntiles = (s_end - s_begin + TS - 1) / TS;

  auto load_tile = [&](int t) {
    copy_tile<T, THREADS>(ring + (t % STAGES) * T::STAGE, k, v, bias, t,
                          ntiles, s_begin, s_end, b, W, K, kk);
  };

  cluster_arrive_relaxed();  // the merge waits for it
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);

  // q's A fragments: rows gr and gr + 8 (zero past G), columns 16 ks + 2 gc
  // (+ 8) of each k step
  const int64_t qbase = ((int64_t)b * H + kk * G) * D;
  uint32_t qa[KS][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q + qbase);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = (16 * ks + 2 * gc) / 2;
      qa[ks][0] = gr < G ? q0[gr * (D / 2) + c] : 0u;
      qa[ks][1] = gr + 8 < G ? q0[(gr + 8) * (D / 2) + c] : 0u;
      qa[ks][2] = gr < G ? q0[gr * (D / 2) + c + 4] : 0u;
      qa[ks][3] = gr + 8 < G ? q0[(gr + 8) * (D / 2) + c + 4] : 0u;
    }
  }

  float m[2] = {kNegBig, kNegBig};     // rows gr, gr + 8
  float l[2] = {0.f, 0.f};             // this lane's part of the row sums
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t is in; the stage of tile t - 1 is free
    load_tile(t + STAGES - 1);
    const unsigned char* sK = ring + (t % STAGES) * T::STAGE;
    const unsigned char* sV = sK + TS * ROW;
    const float* sB = reinterpret_cast<const float*>(sV + TS * ROW);
    const int rows = min(TS, s_end - (s_begin + t * TS));
    const int j0 = 16 * warp;          // this warp's slots in the tile

    // S = Q K^T: n tiles of slots j0 .. j0 + 7 and j0 + 8 .. j0 + 15
    float sf[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int mi = lane >> 3;
      const unsigned char* kr =
          sK + (j0 + (mi >> 1) * 8 + (lane & 7)) * ROW + (mi & 1) * 16;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        ldsm_x4(kb, kr + ks * 32);
        mma_16816(sf[0], qa[ks], kb[0], kb[1]);
        mma_16816(sf[1], qa[ks], kb[2], kb[3]);
      }
    }
    // online softmax of rows gr (sf[.][0..1]) and gr + 8 (sf[.][2..3])
    float p[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + 8 * n + 2 * gc + c;
          const float sv = j < rows ? fmaf(sf[n][2 * h + c], scale, sB[j])
                                    : kNegBig;
          sf[n][2 * h + c] = sv;
          mx = fmaxf(mx, sv);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = expf(m[h] - mx);
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + 8 * n + 2 * gc + c;
          const float pv = j < rows ? expf(sf[n][2 * h + c] - mx) : 0.f;
          p[n][2 * h + c] = pv;
          sum += pv;
        }
      }
      l[h] = fmaf(l[h], alpha, sum);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
    }
    // P's A fragments, hi and lo parts: (gr, slots 2gc..), (gr + 8, ..),
    // then the same 8 slots on
    uint32_t ph[4], pq[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a = p[n][2 * h], c = p[n][2 * h + 1];
        const float ah = __bfloat162float(__float2bfloat16(a));
        const float ch = __bfloat162float(__float2bfloat16(c));
        ph[2 * n + h] = pack_bf16(ah, ch);
        pq[2 * n + h] = pack_bf16(a - ah, c - ch);
      }
    }
    // O += P V: V's B fragments of two n tiles a ldmatrix.trans
    {
      const int mi = lane >> 3;
      const unsigned char* vr =
          sV + (j0 + (mi & 1) * 8 + (lane & 7)) * ROW + (mi >> 1) * 16;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vr + n * 16);
        mma_16816(acc[n], ph, vb[0], vb[1]);
        mma_16816(acc[n], pq, vb[0], vb[1]);
        mma_16816(acc[n + 1], ph, vb[2], vb[3]);
        mma_16816(acc[n + 1], pq, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every tile done: the ring is free

  // the warps' partials, then the block's, merged in warp order
  float* wm = reinterpret_cast<float*>(ring);   // WARPS x MAXG
  float* wl = wm + WARPS * MAXG;                // WARPS x MAXG
  float* wacc = wl + WARPS * MAXG;              // WARPS x MAXG x D
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int g = gr + 8 * h;
    if (g < G) {
      if (gc == 0) {
        wm[warp * MAXG + g] = m[h];
        wl[warp * MAXG + g] = lh;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float* dst = wacc + (warp * MAXG + g) * D + 8 * n + 2 * gc;
        dst[0] = acc[n][2 * h];
        dst[1] = acc[n][2 * h + 1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float mx = kNegBig;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * MAXG + g]);
    float a = 0.f, lsum = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float sc = expf(wm[w * MAXG + g] - mx);
      a = fmaf(wacc[w * MAXG * D + i], sc, a);
      lsum = fmaf(wl[w * MAXG + g], sc, lsum);
    }
    pacc[i] = a;
    if (i - g * D == 0) {
      pm[g] = mx;
      pl[g] = lsum;
    }
  }
  merge_splits(pm, pl, pacc, recv, out + qbase, G, D);
}

}  // namespace tc

// Launches `kernel` on a grid of (nsplit, K, B) blocks, one cluster of
// nsplit blocks per (b, kv head).
template <typename TQ, typename TKV>
cudaError_t launch_clusters(void (*kernel)(const TQ*, const TKV*, const TKV*,
                                           const float*, TQ*, int, int, int,
                                           int, float),
                            int threads, size_t smem,
                            std::atomic<uint64_t>& done,
                            const void* q, const void* k, const void* v,
                            const void* bias, void* out, int B, int W, int H,
                            int K, int cps, int nsplit, float scale,
                            cudaStream_t stream) {
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem,
                               done);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, K, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TQ*>(q),
                           static_cast<const TKV*>(k),
                           static_cast<const TKV*>(v),
                           static_cast<const float*>(bias),
                           static_cast<TQ*>(out), W, K, H / K, cps, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// float32 q (either cache type): the CUDA-core kernel, in a head-group
// bucket of 4 or MAXG; bf16 q and cache: the tensor-core kernel. The
// bucket of 4 (~100 registers) runs two blocks an SM, as the wrapper's
// split plan assumes, so h2o-danube's G = 4 fills the card in one wave;
// the MAXG one (160-168 registers) runs one, and took 2.3x as long at
// that shape (PERF.md, A/B of the float32-q route).
template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int W, int H, int K,
                   int cps, int nsplit, float scale, cudaStream_t st) {
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {
    static std::atomic<uint64_t> done{0};
    return launch_clusters<TQ, TKV>(tc::decode_bf16_kernel<D>, tc::THREADS,
                                    tc::smem_bytes<D>(), done, q, k, v, bias,
                                    out, B, W, H, K, cps, nsplit, scale, st);
  } else if (H / K <= 4) {
    static std::atomic<uint64_t> done{0};
    return launch_clusters<TQ, TKV>(decode_kernel<TQ, TKV, D, 4>, THREADS,
                                    Smem<D, 4>::template bytes<TKV>(), done,
                                    q, k, v, bias, out, B, W, H, K, cps,
                                    nsplit, scale, st);
  } else {
    static std::atomic<uint64_t> done{0};
    return launch_clusters<TQ, TKV>(decode_kernel<TQ, TKV, D, MAXG>, THREADS,
                                    Smem<D, MAXG>::template bytes<TKV>(),
                                    done, q, k, v, bias, out, B, W, H, K, cps,
                                    nsplit, scale, st);
  }
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const void* bias, void* out, int B, int W, int H,
                       int K, int cps, int nsplit, float scale,
                       cudaStream_t st) {
  switch (d) {
    case 32: return launch<TQ, TKV, 32>(q, k, v, bias, out, B, W, H, K, cps, nsplit, scale, st);
    case 64: return launch<TQ, TKV, 64>(q, k, v, bias, out, B, W, H, K, cps, nsplit, scale, st);
    case 80: return launch<TQ, TKV, 80>(q, k, v, bias, out, B, W, H, K, cps, nsplit, scale, st);
    case 112: return launch<TQ, TKV, 112>(q, k, v, bias, out, B, W, H, K, cps, nsplit, scale, st);
    case 128: return launch<TQ, TKV, 128>(q, k, v, bias, out, B, W, H, K, cps, nsplit, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Slots of a chunk: the wrapper gives each block of a cluster a whole
// number of chunks.
int decode_attention_slots_per_chunk() { return CH; }

int decode_attention_max_group() { return MAXG; }

int decode_attention_max_splits() { return MAX_SPLITS; }

// One launch: nsplit = ceil(ceil(W / CH) / chunks_per_split) blocks of a
// cluster per (b, kv head), at most MAX_SPLITS. Returns a cudaError_t: 0
// when the launch was accepted.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* out, int B, int W, int H,
                         int K, int d, int q_dtype, int kv_dtype,
                         int chunks_per_split, float scale, void* stream) {
  if (B <= 0 || W <= 0 || K <= 0 || H % K != 0 || H / K > MAXG ||
      chunks_per_split <= 0)
    return cudaErrorInvalidValue;
  const int chunks = (W + CH - 1) / CH;
  const int nsplit = (chunks + chunks_per_split - 1) / chunks_per_split;
  if (nsplit > MAX_SPLITS) return cudaErrorInvalidValue;
  const int cps = chunks_per_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return dispatch_d<float, float>(d, q, k, v, bias, out, B, W, H, K, cps, nsplit, scale, st);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, q, k, v, bias, out, B, W, H, K, cps, nsplit, scale, st);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return dispatch_d<float, __nv_bfloat16>(d, q, k, v, bias, out, B, W, H, K, cps, nsplit, scale, st);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
