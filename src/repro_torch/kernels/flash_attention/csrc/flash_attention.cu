// Flash attention forward (prefill) for NVIDIA Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py). Same function:
// causal / sliding-window GQA attention with an online softmax in float32,
// query head h reading kv head h / (H / K), scale 1/sqrt(d) of the true d.
//
// Layout: q (B,S,H,d), k/v (B,S,K,d), o (B,S,H,d), all contiguous, read in
// place (no transposes, no padding of S or d; the ragged S edge is masked
// here). Inputs are float32 or bfloat16, the output has q's type.
//
// Design. One block of 256 threads per (q-tile of 64 rows, head, batch).
// The TPU grid's sequential k axis becomes a loop inside the block, and the
// reference's causal / window block skip becomes that loop's bounds. Each
// thread (ty, tx) of a 16x16 layout owns rows 4*ty..4*ty+3 of the tile: for
// the scores, columns tx + 16*j of the 64-key tile (a 4x4 register tile);
// for the output, head-dim columns tx + 16*c (d / 16 of them). Row max and
// row sum reduce over the 16 lanes that share the rows with warp shuffles.
// q, k, v and the probabilities are staged in shared memory as float32
// (row stride d + 1, so the column reads do not conflict on banks).
//
// What bounds it on the H100: operations. At h2o-danube's prefill shape
// (B=4, S=4160, H=32, K=8, d=80, window 4096) the two products are 3.5e11
// FLOP per layer against 2.1e8 bytes moved, so even at the bf16
// tensor-core peak the operations take longer than the bytes (about 0.36
// ms against 0.064 ms; H100 SXM data-sheet peaks at the 700 W limit,
// computed, not measured). This first version runs both products in
// float32 on CUDA cores (67 TFLOP/s data-sheet peak),
// fed from shared memory: 8 shared loads per 16 FMAs, so shared-memory
// bandwidth caps it near half that peak. The route to the bound is
// mma.sync / wgmma on bf16 tiles with TMA loads; that is later work.
#include "common.cuh"

namespace {

using namespace repro_torch;

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int K, int causal, int window,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, K, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int B, int S, int H, int K, int causal,
                       int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, K, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, K, causal, window, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, S, H, K, causal, window, scale, stream);
    case 112: return launch<T, 112>(q, k, v, o, B, S, H, K, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, K, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. window <= 0 means
// no sliding window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int K, int d, int dtype,
                        int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(d, q, k, v, o, B, S, H, K, causal, window, scale, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, B, S, H, K, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
