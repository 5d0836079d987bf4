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
// Design. The TPU grid (B, K, n_w) walks W in order inside one program per
// (b, kv head): 32 programs at B=4, K=8, which would leave 100 of the
// H100's 132 SMs idle. Here W is split across blocks (flash-decoding): a
// block of 128 threads takes 128 cache slots of one (b, kv head), one slot
// per thread, and writes a partial (m, l, acc) per query head in float32;
// a second small kernel merges the partials. The G = H/K query heads of a
// kv group ride in one block, so each K/V byte is read from device memory
// once. K and V tiles are loaded with 16-byte vector loads into shared
// memory (row stride d + 1, so per-slot row reads do not conflict).
//
// What bounds it on the H100: bytes. At h2o-danube's decode shape (B=4,
// W=4096, K=8, d=80, bf16) the K/V cache is 42 MB per layer: 12.5 us at
// the 3.35 TB/s data-sheet rate (700 W limit; computed, not measured),
// against 1.7e8 FLOP. The split gives 4 * 8 * 32 = 1024 blocks
// so every SM has loads in flight.
#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int CH = 128;  // cache slots per block, one per thread
constexpr int THREADS = CH;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 16;  // query heads per kv head

template <int D>
constexpr size_t split_smem_bytes() {
  return sizeof(float) * (CH * (D + 1) + MAXG * D + MAXG * CH);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ bias,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int W, int K, int G,
                    float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DS = D + 1;
  extern __shared__ float smem[];
  float* sKV = smem;          // CH x DS: the K tile, then the V tile
  float* sQ = sKV + CH * DS;  // G x D, pre-scaled
  float* sS = sQ + MAXG * D;  // G x CH: scores, then probabilities
  __shared__ float red[MAXG][WARPS];
  __shared__ float row_max[MAXG];

  const int split = blockIdx.x;
  const int kk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = K * G;
  const int w0 = split * CH;
  const int rows = min(CH, W - w0);

  load_rows<TQ, D>(q, sQ, D, G, scale, [&](int g) -> int64_t {
    return ((int64_t)b * H + kk * G + g) * D;
  });
  auto kv_row = [&](int r) -> int64_t {
    return r < rows ? (((int64_t)b * W + w0 + r) * K + kk) * D : -1;
  };
  load_rows<TKV, D>(k, sKV, DS, CH, 1.f, kv_row);
  __syncthreads();

  const bool live = tid < rows;
  const float slot_bias = live ? bias[(int64_t)b * W + w0 + tid] : 0.f;
  for (int g = 0; g < G; ++g) {
    float s = kNegBig;
    if (live) {
      float dot = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) dot = fmaf(sQ[g * D + e], sKV[tid * DS + e], dot);
      s = dot + slot_bias;
    }
    sS[g * CH + tid] = s;
    const float mx = warp_max(s);
    if (lane == 0) red[g][warp] = mx;
  }
  __syncthreads();  // scores done: the K tile and red[] may be reused
  if (tid < G) {
    float mx = red[tid][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red[tid][w]);
    row_max[tid] = mx;
  }
  load_rows<TKV, D>(v, sKV, DS, CH, 1.f, kv_row);
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    const float p = live ? expf(sS[g * CH + tid] - row_max[g]) : 0.f;
    sS[g * CH + tid] = p;
    const float sum = warp_sum(p);
    if (lane == 0) red[g][warp] = sum;
  }
  __syncthreads();

  const int64_t pbase = ((int64_t)(b * K + kk) * gridDim.x + split) * G;
  if (tid < G) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[tid][w];
    part_m[pbase + tid] = row_max[tid];
    part_l[pbase + tid] = sum;
  }
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    const int e = i - g * D;
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < rows; ++j) a = fmaf(sS[g * CH + j], sKV[j * DS + e], a);
    part_acc[(pbase + g) * D + e] = a;
  }
}

// Merges the partials of all splits: one block per (head, batch), one
// thread per head-dim column.
template <typename TO, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, TO* __restrict__ out,
                      int K, int G, int nsplit) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int e = threadIdx.x;
  const int H = K * G;
  const int kk = h / G;
  const int g = h - kk * G;
  const int64_t base = (int64_t)(b * K + kk) * nsplit * G + g;
  float mx = kNegBig;
  for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, part_m[base + sp * G]);
  float l = 0.f, a = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const int64_t idx = base + (int64_t)sp * G;
    const float w = expf(part_m[idx] - mx);
    l = fmaf(part_l[idx], w, l);
    a = fmaf(part_acc[idx * D + e], w, a);
  }
  store(out + ((int64_t)b * H + h) * D + e, a / fmaxf(l, 1e-30f));
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* part_m, void* part_l,
                   void* part_acc, void* out, int B, int W, int H, int K,
                   int nsplit, float scale, cudaStream_t stream) {
  const int G = H / K;
  auto split = decode_split_kernel<TQ, TKV, D>;
  constexpr size_t smem = split_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  split<<<dim3(nsplit, K, B), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(bias),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), W, K, G, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<TQ, D><<<dim3(H, B), D, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<TQ*>(out), K, G,
      nsplit);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const void* bias, void* pm, void* pl, void* pa,
                       void* out, int B, int W, int H, int K, int nsplit,
                       float scale, cudaStream_t st) {
  switch (d) {
    case 32: return launch<TQ, TKV, 32>(q, k, v, bias, pm, pl, pa, out, B, W, H, K, nsplit, scale, st);
    case 64: return launch<TQ, TKV, 64>(q, k, v, bias, pm, pl, pa, out, B, W, H, K, nsplit, scale, st);
    case 80: return launch<TQ, TKV, 80>(q, k, v, bias, pm, pl, pa, out, B, W, H, K, nsplit, scale, st);
    case 112: return launch<TQ, TKV, 112>(q, k, v, bias, pm, pl, pa, out, B, W, H, K, nsplit, scale, st);
    case 128: return launch<TQ, TKV, 128>(q, k, v, bias, pm, pl, pa, out, B, W, H, K, nsplit, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Slots of the cache that one block of the split kernel covers; the wrapper
// sizes the partials with it.
int decode_attention_slots_per_block() { return CH; }

int decode_attention_max_group() { return MAXG; }

// part_m, part_l: (B, K, nsplit, G) float32; part_acc: (B, K, nsplit, G, d)
// float32, with nsplit = ceil(W / slots_per_block). Returns a cudaError_t:
// 0 when both launches were accepted.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* part_m, void* part_l,
                         void* part_acc, void* out, int B, int W, int H,
                         int K, int d, int q_dtype, int kv_dtype, int nsplit,
                         float scale, void* stream) {
  if (B <= 0 || W <= 0 || K <= 0 || H % K != 0 || H / K > MAXG ||
      nsplit != (W + CH - 1) / CH)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return dispatch_d<float, float>(d, q, k, v, bias, part_m, part_l, part_acc, out, B, W, H, K, nsplit, scale, st);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16>(d, q, k, v, bias, part_m, part_l, part_acc, out, B, W, H, K, nsplit, scale, st);
  if (q_dtype == kF32 && kv_dtype == kBF16)
    return dispatch_d<float, __nv_bfloat16>(d, q, k, v, bias, part_m, part_l, part_acc, out, B, W, H, K, nsplit, scale, st);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
