// Flash attention forward (prefill) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py). Same function:
// causal / sliding-window GQA attention with an online softmax in float32,
// query head h reading kv head h / (H / K), scale 1/sqrt(d) of the true d,
// the output divided by max(l, 1e-30).
//
// Layout: q (B,S,H,d), k/v (B,S,K,d), o (B,S,H,d), all contiguous, read in
// place (no transposes, no padding of S or d; the ragged S edge is masked
// here). The output has q's type. Two kernels behind one C entry, chosen
// by the inputs' type:
//
// * bfloat16 -> `tc::flash_fwd_bf16_kernel`, on tensor cores (wgmma);
// * float32  -> `flash_fwd_kernel`, both products in float32 on CUDA cores.
//   The float32 serve and train paths are held to the plain version at
//   1e-4 and 1e-5, which TF32 products would not meet.
//
// What bounds it on the H100: operations. At h2o-danube's prefill shape
// (B=4, S=4160, H=32, K=8, d=80, window 4096) the two products are 3.5e11
// FLOP per layer against 2.1e8 bytes moved, so at the bf16 tensor-core
// peak the operations take longer than the bytes (about 0.36 ms against
// 0.064 ms; H100 SXM data-sheet peaks at the 700 W limit, computed, not
// measured).
//
// Design of the bfloat16 kernel. One block of two warpgroups (256
// threads, two blocks an SM at d <= 80) per (128-row q-tile, head, batch);
// each warpgroup owns 64 rows. The TPU grid's sequential k axis is a loop
// over 64-key tiles inside the block, bounded by the causal / window
// skip, and each warpgroup computes only the tiles its rows see. q, k and
// v stay bf16 as stored and are read in place by TMA, in boxes of 16
// columns that land with the 32-byte swizzle, which wgmma reads for any d
// that is a multiple of 16 (d = 80 and 112 need nothing special) and
// which reads whole 32-byte sectors. K/V tiles sit in a ring of four
// stages with a full and an empty mbarrier each; thread 0 keeps two tiles
// in flight, so the copies run while the products do and no block-wide
// barrier is left in the loop. Per tile and warpgroup:
//   S = Q K^T   wgmma m64n64k16, both operands from shared memory (K
//               row-major is the K-major B operand), float32 accumulator;
//   softmax     in float32: the finite kNegBig mask only on tiles that
//               straddle the diagonal, the window's lower edge or S; row
//               max and sum over the 4 threads that share a row in the
//               accumulator layout; p = 2^(s c - m c), c = scale log2(e),
//               one FFMA and one ex2; the online rescale of O in
//               registers;
//   O += P V    wgmma m64n(d)k16 with P the A operand from registers and
//               V the B operand from shared memory (MN-major). P is split
//               into P_hi = bf16(p) and P_lo = bf16(p - P_hi), two wgmma
//               into one accumulator: p keeps ~16 bits, an error of at most
//               2^-16 p |v| a term, where one bf16 rounding errs by up to
//               2^-8 p |v| and the bf16 output's own rounding already takes
//               the 2^-8 |ref| of the gate held against the float32 plain
//               version. It costs half again the FLOP of a bf16 P.
// The heaviest q-tiles (the last ones under a causal mask) are launched
// first. What was tried on the H100 and kept out (PERF.md): cp.async
// loads by all threads, 16-byte TMA boxes, 128-key tiles, four
// warpgroups a block, a software pipeline that overlaps one tile's
// softmax with the last tile's P V, and a cluster of the query heads of
// one kv head sharing each K/V tile by TMA multicast.
#include <cuda.h>
#include <cudaTypedefs.h>

#include <atomic>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro_torch;

// ---- float32: CUDA cores ------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per loop step
constexpr int THREADS = 256;  // 16 x 16

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int K, int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DS = D + 1;   // shared row stride of the q and k tiles
  constexpr int PS = BK + 1;  // shared row stride of the probabilities
  constexpr int DT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;           // BQ x DS, pre-scaled
  float* sK = sQ + BQ * DS;   // BK x DS
  float* sV = sK + BK * DS;   // BK x D
  float* sP = sV + BK * D;    // BQ x PS

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);

  load_rows<T, D>(q, sQ, DS, BQ, scale, [&](int r) -> int64_t {
    const int s = q0 + r;
    return s < S ? (((int64_t)b * S + s) * H + h) * D : -1;
  });

  // keys this tile can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - (window - 1));

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous step is done with sK, sV and sP
    auto kv_row = [&](int r) -> int64_t {
      const int s = k0 + r;
      return s < S ? (((int64_t)b * S + s) * K + kh) * D : -1;
    };
    load_rows<T, D>(k, sK, DS, BK, 1.f, kv_row);
    load_rows<T, D>(v, sV, D, BK, 1.f, kv_row);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty * 4 + i) * DS + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tx + 16 * j) * DS + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < S;
        if (causal) ok = ok && row >= col;
        if (window > 0) ok = ok && row - col < window;
        if (!ok) s[i][j] = kNegBig;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[DT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DT; ++c) vv[c] = sV[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DT; ++c) store(orow + tx + 16 * c, acc[i][c] / denom);
  }
}

// ---- bfloat16: tensor cores ----------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;       // query rows per block, 64 per warpgroup
constexpr int BK = 64;        // keys per tile
constexpr int NS = BK / 2;    // score accumulator registers a thread
constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int STAGES = 4;     // K/V tiles in the ring
constexpr int LAG = 2;        // a stage is refilled LAG tiles after its use

// Q tile, STAGES x (K tile, V tile), bf16; then the mbarriers
template <int D>
__host__ __device__ constexpr size_t tiles_bytes() {
  return sizeof(bf16) * (BQ * D + STAGES * 2 * BK * D);
}
// and 1 KB to align the tiles to the 1 KB the swizzled TMA boxes need
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + tiles_bytes<D>() + sizeof(uint64_t) * (2 * STAGES + 1);
}

// A tile of R rows x D sits in shared memory as D / 16 pieces of R rows x
// 32 bytes (16 columns), piece c at byte c * R * 32, each written by one
// TMA box of (16 elements, 1 head, R rows, 1 batch) with the 32-byte
// swizzle: every row of a box is one whole 32-byte sector of global
// memory. Each piece is a column of wgmma's 32-byte-swizzle atoms (8 rows
// x 32 bytes, 256 bytes), which serve both as K-major operands (Q and K:
// a piece is one k step of 16) and as MN-major ones (V: 16 columns of N
// per piece, 8 keys per atom). `load_rows` starts the D / 16 boxes of
// rows s0 .. s0 + R - 1 of head `head` (TMA zero-fills rows at or past S).
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head, int s0,
                                          int b) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
    sm90::tma_load_4d(dst + c * R * 16, map, bar, c * 16, head, s0, b);
}

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 80 ? 2 : 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      bf16* __restrict__ o, int S, int H, int K, int causal,
                      int window, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int TILE = BK * D;  // elements of one K or V tile
  constexpr int NO = D / 2;     // O accumulator registers
  constexpr uint32_t KV_BYTES = 2 * TILE * sizeof(bf16);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sKV = sQ + BQ * D;  // stage st: K at 2 st TILE, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(base + tiles_bytes<D>());
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  auto stage = [&](int tile) { return sKV + 2 * (tile % STAGES) * TILE; };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest first
  const int kh = h / (H / K);

  // keys the block can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - (window - 1));
  const int first = (k_lo / BK) * BK;
  const int n_tiles = (k_hi - first + BK - 1) / BK;

  // Thread 0 starts every copy. A stage holds tile t, then t + STAGES:
  // full[st] completes when a tile has landed, empty[st] when all 256
  // threads are done with it. Step `it` starts tile it + STAGES - LAG into
  // the stage of tile it - LAG, so thread 0 waits only if the other
  // warpgroup trails its own by LAG steps or more.
  auto produce = [&](int t) {
    if (t >= n_tiles) return;
    const int st = t % STAGES;
    if (t >= STAGES) sm90::mbar_wait(&empty[st], ((t / STAGES) - 1) & 1);
    sm90::mbar_arrive_expect_tx(&full[st], KV_BYTES);
    bf16* dst = stage(t);
    load_rows<D, BK>(dst, &tm_k, &full[st], kh, first + t * BK, b);
    load_rows<D, BK>(dst + TILE, &tm_v, &full[st], kh, first + t * BK, b);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], THREADS);
    }
    sm90::mbar_init(q_full, 1);
    sm90::fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(q_full, BQ * D * sizeof(bf16));
    load_rows<D, BQ>(sQ, &tm_q, q_full, h, q0, b);
#pragma unroll
    for (int t = 0; t < STAGES - LAG; ++t) produce(t);
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int r0 = q0 + wg * 64;  // the warpgroup's first row
  // this thread's two rows of the accumulators: row_a and row_a + 8
  const int row_a = r0 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
  const int tq = lane % 4;
  // descriptors (see load_rows), all of 32-byte-swizzle atoms: Q and K
  // are K-major (SBO steps 8 rows; a k step is a piece), V is MN-major
  // (LBO steps a piece of 16 columns of N, SBO 8 keys)
  const uint64_t desc_q = sm90::make_desc(sQ + wg * 64 * 16, 16, 256);
  const float c = scale * 1.4426950408889634f;  // scores to log2 units

  // the warpgroup's own tiles [wg_lo, wg_hi] of the block's n_tiles: a
  // tile outside them is masked for all of its 64 rows
  int wg_lo = 0, wg_hi = -1;
  if (r0 < S) {
    const int lo = window > 0 ? max(0, r0 - (window - 1)) : 0;
    const int hi = causal ? min(S, r0 + 64) : S;
    wg_lo = (lo - first) / BK;
    wg_hi = (hi - 1 - first) / BK;
  }

  float s[NS], acc[NO];
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  sm90::mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    if (threadIdx.x == 0) produce(it + STAGES - LAG);
    __syncwarp();
    // every thread waits for every tile, its own or not, so that none
    // arrives on a stage's next phase early
    sm90::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    if (it >= wg_lo && it <= wg_hi) {
      const int k0 = first + it * BK;
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && r0 + 63 - k0 >= window);
      const bf16* sK = stage(it);
      const uint64_t desc_k = sm90::make_desc(sK, 16, 256);
      const uint64_t desc_v = sm90::make_desc(sK + TILE, BK * 32, 256);

      // S = Q K^T: d / 16 steps of 16 columns, a piece each (descriptor
      // addresses count 16 bytes)
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_ss(s, desc_q + kk * (BQ * 32 / 16),
                       desc_k + kk * (BK * 32 / 16), kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // the row max of the raw scores (the scale is positive), then
      // p = 2^(s c - m c), c = scale log2(e): one FFMA and one ex2
      float mx[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int row = row_a + (e >> 1) * 8;
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            bool ok = col < S;
            if (causal) ok = ok && row >= col;
            if (window > 0) ok = ok && row - col < window;
            if (!ok) s[4 * j + e] = kNegBig;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
        }
      }
      float alpha[2], mc[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = sm90::ex2((m[i] - m_new) * c);
        m[i] = m_new;
        // While a row has seen no key (m is still kNegBig), m c is taken as
        // 0, so that its p = 2^(kNegBig c) = 0: the FFMA below would leave
        // the rounding error of kNegBig c, up to ~1e22, and 2^(1e22) = inf.
        mc[i] = m_new == kNegBig ? 0.f : m_new * c;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = sm90::ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
        rs[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
        rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
        l[i] = l[i] * alpha[i] + rs[i];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // P as the A operand of BK / 16 steps of 16 keys, split into hi and
      // lo parts
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a0 = s[8 * kk + 2 * r], a1 = s[8 * kk + 2 * r + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a0, a1);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][r] = sm90::pack_bf16(a0 - hf.x, a1 - hf.y);
        }
      }
      // O += P V: steps of 16 keys (two atoms, 512 bytes)
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        sm90::wgmma_rs(acc, p_hi[kk], desc_v + kk * (512 / 16));
        sm90::wgmma_rs(acc, p_lo[kk], desc_v + kk * (512 / 16));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        sm90::fence_regs(p_hi[kk]);
        sm90::fence_regs(p_lo[kk]);
      }
    }
    sm90::mbar_arrive(&empty[it % STAGES]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* orow = o + (((int64_t)b * S + row) * H + h) * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = sm90::pack_bf16(
          acc[4 * j + 2 * i] / denom, acc[4 * j + 2 * i + 1] / denom);
  }
}

// The tensor map of a (B, S, heads, D) bf16 tensor read in place, whose
// boxes are (16 elements, 1 head, `rows` rows, 1 batch), written to shared
// memory with the 32-byte swizzle. Returns false if cuTensorMapEncodeTiled
// is not found or refuses the map.
inline bool make_map(CUtensorMap* map, const void* base, int B, int S,
                     int heads, int D, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)D * sizeof(bf16);
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {16, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int K, int causal, int window,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem,
                               done);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, K, causal, window,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int K, int causal, int window,
                        float scale, cudaStream_t stream) {
  auto kernel = tc::flash_fwd_bf16_kernel<D>;
  constexpr size_t smem = tc::smem_bytes<D>();
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem,
                               done);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tc::make_map(&tm_q, q, B, S, H, D, tc::BQ) ||
      !tc::make_map(&tm_k, k, B, S, K, D, tc::BK) ||
      !tc::make_map(&tm_v, v, B, S, K, D, tc::BK))
    return cudaErrorInvalidValue;
  const dim3 grid(H, B, (S + tc::BQ - 1) / tc::BQ);
  kernel<<<grid, tc::THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<tc::bf16*>(o), S, H, K, causal, window,
      scale);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int d, const void* q, const void* k, const void* v,
                         void* o, int B, int S, int H, int K, int causal,
                         int window, float scale, cudaStream_t st) {
  switch (d) {
    case 32: return launch<float, 32>(q, k, v, o, B, S, H, K, causal, window, scale, st);
    case 64: return launch<float, 64>(q, k, v, o, B, S, H, K, causal, window, scale, st);
    case 80: return launch<float, 80>(q, k, v, o, B, S, H, K, causal, window, scale, st);
    case 112: return launch<float, 112>(q, k, v, o, B, S, H, K, causal, window, scale, st);
    case 128: return launch<float, 128>(q, k, v, o, B, S, H, K, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(int d, const void* q, const void* k, const void* v,
                          void* o, int B, int S, int H, int K, int causal,
                          int window, float scale, cudaStream_t st) {
  switch (d) {
    case 32: return launch_bf16<32>(q, k, v, o, B, S, H, K, causal, window, scale, st);
    case 64: return launch_bf16<64>(q, k, v, o, B, S, H, K, causal, window, scale, st);
    case 80: return launch_bf16<80>(q, k, v, o, B, S, H, K, causal, window, scale, st);
    case 112: return launch_bf16<112>(q, k, v, o, B, S, H, K, causal, window, scale, st);
    case 128: return launch_bf16<128>(q, k, v, o, B, S, H, K, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. window <= 0 means
// no sliding window. float32 inputs take the CUDA-core kernel, bfloat16
// ones the tensor-core kernel.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int K, int d, int dtype,
                        int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_f32(d, q, k, v, o, B, S, H, K, causal, window, scale, st);
  if (dtype == kBF16)
    return dispatch_bf16(d, q, k, v, o, B, S, H, K, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
