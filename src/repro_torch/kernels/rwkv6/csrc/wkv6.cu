// RWKV6 (Finch) WKV forward for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `wkv6_fwd` (src/repro/kernels/rwkv6/
// rwkv6.py). Same function: the WKV recurrence with data-dependent decay
// from a zero initial state,
//
//     o_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//     S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,
//
// returning o and the final state S_S.
//
// Layout: r, k, v, logw (B,H,S,d) and o (B,H,S,d), u (H,d), s_final
// (B,H,d,d) with row i and column j; all float32, contiguous, read in
// place. d is a template parameter (16, 32 or 64).
//
// What bounds it on the H100. It reads r, k, v and logw and writes o, 134
// MB each at rwkv6-7b's training shape (B=4, H=64, S=2048, d=64): 0.67 GB,
// 0.20 ms at 3.35 TB/s. Per state entry and token it runs three float32
// instructions (two FMA and a multiply): 6.4e9 at that shape, 0.22 ms on
// the 124 SMs that hold two of the 256 blocks (H100 SXM data sheet, 700 W;
// computed, not measured). Neither bound is reached by a kernel that waits
// for each token's loads, which is what the first version did.
//
// Design. The TPU kernel re-blocked the recurrence into chunks of 64 tokens
// to feed its matrix unit, with a (c,c,d) tensor of decay ratios per chunk.
// Here the recurrence stays token by token (every exponent a single logw <=
// 0, so nothing overflows even at logw = -30), one block per (b, h):
//
// - Chunks: r, k, v and logw of T tokens (16 at d >= 32, 32 at d = 16) are
//   copied by cp.async in 16-byte pieces into a ring of STAGES stages in
//   shared memory; chunk c + 1 is in flight while chunk c computes. A
//   ragged last chunk is zero-filled (logw = 0 and zero k, v: such tokens
//   change nothing) and not stored.
// - A parallel pass per chunk turns logw into w = exp(logw) in place and
//   computes each token's bonus r_t . (u * k_t), a scalar, so that
//   o_t[j] = sum_i r_t[i] S[i][j] + bonus_t v_t[j].
// - The state: thread (p, q) holds C = 4 columns (2 at d = 16), C p ..
//   C p + C - 1, of S for the rows 4 (q + LANES m) + c (c < 4): the rows
//   of a column group are split over LANES = 8 lanes (4 at d = 16), 32
//   floats a thread at d = 64. Each float4 read of r, w or k from shared
//   memory feeds 4 rows x C columns; a quarter warp's eight lanes read
//   eight neighbouring float4, so the reads hit distinct banks. There is
//   no block barrier and no shuffle inside a chunk: each lane stores its
//   partial o_t (lane 0 adds the bonus term) in shared memory, rows padded
//   to other banks.
// - After the chunk, o is the lanes' partials summed in lane order,
//   written with 16-byte stores, coalesced.
// d = 64 gives 128 threads a block and two blocks an SM: all 256 blocks of
// rwkv6-7b's shape in one wave, 8 warps an SM.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::sm90;

constexpr int STAGES = 2;

template <int D>
struct Layout {
  static constexpr int C = D >= 32 ? 4 : 2;      // state columns a thread
  static constexpr int LANES = D >= 32 ? 8 : 4;  // lanes that split the rows
  static constexpr int T = LANES >= 8 ? 16 : 32; // tokens a chunk
  static constexpr int THREADS = D / C * LANES;
  static constexpr int RB = D / (4 * LANES);     // row blocks of 4 a thread
  static constexpr int TILE = T * D;       // floats of one input's chunk
  static constexpr int STAGE = 4 * TILE;   // r, k, v, logw (then w)
  // a row of partial o, padded so that the lanes' rows start on other banks
  static constexpr int DP = D + 4;
  // the ring, the lanes' partial o, the bonuses, u
  static constexpr size_t SMEM =
      4 * ((size_t)STAGES * STAGE + (size_t)LANES * T * DP + T + D);
};

// C neighbouring floats of shared memory, 16-byte aligned (8 for C = 2).
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[C]) {
  if constexpr (C == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      x[i] = f.x;
      x[i + 1] = f.y;
      x[i + 2] = f.z;
      x[i + 3] = f.w;
    }
  }
}
template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[C]) {
  if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(Layout<D>::THREADS)
wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, float* __restrict__ o,
                float* __restrict__ s_final, int H, int S) {
  using L = Layout<D>;
  constexpr int C = L::C;
  constexpr int LANES = L::LANES;
  constexpr int T = L::T;
  constexpr int NT = L::THREADS;
  constexpr int TILE = L::TILE;
  constexpr int DP = L::DP;
  constexpr int TPT = NT / T;              // threads a token in the pass
  static_assert(NT % 32 == 0 && TPT >= 1,
                "whole warps, a thread a token at least");
  extern __shared__ __align__(16) float smem[];
  float* sPart = smem + STAGES * L::STAGE;  // T x LANES x DP partial o
  float* sBonus = sPart + LANES * T * DP;   // T
  float* sU = sBonus + T;                   // D

  const int bh = blockIdx.x;               // b * H + h
  const int tid = threadIdx.x;
  const int q = tid % LANES;
  const int j0 = tid / LANES * C;          // the columns j0 .. j0 + C - 1
  const int64_t base = (int64_t)bh * S * D;
  const int nchunks = (S + T - 1) / T;
  for (int i = tid; i < D; i += NT) sU[i] = u[(bh % H) * D + i];

  // the chunk c of all four inputs into its stage: contiguous in (S, D)
  auto load_chunk = [&](int c) {
    if (c < nchunks) {
      float* st = smem + (c % STAGES) * L::STAGE;
      const int64_t first = (int64_t)c * TILE;
      for (int i = tid * 4; i < TILE; i += NT * 4) {
        const bool ok = first + i < (int64_t)S * D;
        const int64_t off = ok ? base + first + i : 0;
        cp_async16(st + i, r + off, ok);
        cp_async16(st + TILE + i, k + off, ok);
        cp_async16(st + 2 * TILE + i, v + off, ok);
        cp_async16(st + 3 * TILE + i, logw + off, ok);
      }
    }
    cp_async_commit();
  };

  float state[L::RB][4][C];                // rows 4 (q + LANES m) + c
#pragma unroll
  for (int m = 0; m < L::RB; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int x = 0; x < C; ++x) state[m][c][x] = 0.f;

  load_chunk(0);
  for (int c = 0; c < nchunks; ++c) {
    load_chunk(c + 1);  // its stage held chunk c - 1, done at the last barrier
    cp_async_wait<1>();
    __syncthreads();  // chunk c is in
    const float* sR = smem + (c % STAGES) * L::STAGE;
    const float* sK = sR + TILE;
    const float* sV = sR + 2 * TILE;
    float* sW = smem + (c % STAGES) * L::STAGE + 3 * TILE;
    const int n = min(T, S - c * T);

    for (int i = tid; i < TILE; i += NT) sW[i] = expf(sW[i]);
    {  // bonus_t = sum_i r_t[i] u[i] k_t[i]: TPT threads a token
      const int t = tid / TPT;
      const int part = tid - t * TPT;
      constexpr int PER = D / TPT;
      float a = 0.f;
#pragma unroll
      for (int i = part * PER; i < part * PER + PER; ++i)
        a = fmaf(sR[t * D + i] * sU[i], sK[t * D + i], a);
#pragma unroll
      for (int off = 1; off < TPT; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (part == 0) sBonus[t] = a;
    }
    __syncthreads();  // w and the bonuses in

    for (int t = 0; t < n; ++t) {
      const float* rt = sR + t * D;
      const float* kt = sK + t * D;
      const float* wt = sW + t * D;
      float vc[C];
      load_cols<C>(sV + t * D + j0, vc);
      float a[C];
#pragma unroll
      for (int x = 0; x < C; ++x) a[x] = 0.f;
#pragma unroll
      for (int m = 0; m < L::RB; ++m) {
        const int i0 = 4 * (q + LANES * m);
        float rv[4], kv[4], wv[4];
        load_cols<4>(rt + i0, rv);
        load_cols<4>(kt + i0, kv);
        load_cols<4>(wt + i0, wv);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int x = 0; x < C; ++x) {
            const float sv = state[m][cc][x];
            a[x] = fmaf(rv[cc], sv, a[x]);
            state[m][cc][x] = fmaf(wv[cc], sv, kv[cc] * vc[x]);
          }
        }
      }
      if (q == 0) {  // lane 0 adds the bonus term
        const float bt = sBonus[t];
#pragma unroll
        for (int x = 0; x < C; ++x) a[x] = fmaf(bt, vc[x], a[x]);
      }
      store_cols<C>(sPart + (t * LANES + q) * DP + j0, a);
    }
    __syncthreads();  // the partials in; the stage may be refilled

    // o = the lanes' partials summed in lane order, 16-byte stores
    float* og = o + base + (int64_t)c * TILE;
    for (int i = tid * 4; i < n * D; i += NT * 4) {
      const int t = i / D;
      const float* pp = sPart + t * LANES * DP + (i - t * D);
      float4 acc = *reinterpret_cast<const float4*>(pp);
#pragma unroll
      for (int l = 1; l < LANES; ++l) {
        const float4 x = *reinterpret_cast<const float4*>(pp + l * DP);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      *reinterpret_cast<float4*>(og + i) = acc;
    }
  }

  float* sf = s_final + (int64_t)bh * D * D + j0;
#pragma unroll
  for (int m = 0; m < L::RB; ++m)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      store_cols<C>(sf + (4 * (q + LANES * m) + cc) * D, state[m][cc]);
}

template <int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, void* o, void* s_final,
                   int B, int H, int S, cudaStream_t stream) {
  auto kernel = wkv6_fwd_kernel<D>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel),
                               Layout<D>::SMEM, done);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, Layout<D>::THREADS, Layout<D>::SMEM, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<float*>(o),
      static_cast<float*>(s_final), H, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. All pointers are
// float32 device pointers.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* logw,
             const void* u, void* o, void* s_final, int B, int H, int S,
             int d, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(r, k, v, logw, u, o, s_final, B, H, S, st);
    case 32: return launch<32>(r, k, v, logw, u, o, s_final, B, H, S, st);
    case 64: return launch<64>(r, k, v, logw, u, o, s_final, B, H, S, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
