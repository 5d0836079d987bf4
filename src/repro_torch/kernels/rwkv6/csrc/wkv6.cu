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
// (B,H,d,d); all float32, contiguous, read in place. d is a template
// parameter (16, 32 or 64).
//
// Design. The TPU kernel re-blocked the recurrence into chunks of 64 tokens
// to feed its matrix unit, which takes a (c,c,d) tensor of decay ratios per
// chunk. This first Hopper version runs the recurrence token by token
// instead: one block per (b, h) with d threads, thread j holding column j
// of S (d floats in registers). Per token, thread j stages r_t[j],
// u[j] k_t[j], exp(logw_t[j]) and k_t[j] in shared memory (double-buffered,
// one barrier per token; the next token's inputs are loaded into registers
// while this one computes), then
//
//     o_t[j]  = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] = exp(logw_t[i]) S[i][j] + k_t[i] v_t[j].
//
// Every exponent is a single logw <= 0, so nothing can overflow, even at
// logw = -30 where the chunked form's factored exponents would reach
// exp(+1920); the (c,c,d) tensor never exists; a ragged S needs no padding.
//
// What bounds it on the H100: bytes. At rwkv6-7b's training shape (B=4,
// H=64, S=2048, d=64) it reads r, k, v and logw and writes o, 134 MB each
// in float32: 0.67 GB, 0.20 ms at 3.35 TB/s. It does 5 B H S d^2 = 1.1e10
// FLOP, 0.16 ms at the 67 TFLOP/s float32 CUDA-core peak (H100 SXM data
// sheet, 700 W; computed, not measured). With B*H = 256 blocks of 64
// threads the card holds about four warps per SM, and each token's d
// dependent FMAs plus a barrier set the pace: the kernel is latency-bound,
// far from both bounds. Spreading the value columns of one head across
// several blocks, and the chunked tensor-core form, are later work.
#include "common.cuh"

namespace {

using namespace repro_torch;

template <int D>
__global__ void __launch_bounds__(D)
wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, float* __restrict__ o,
                float* __restrict__ s_final, int H, int S) {
  // per token and row i: (r[i], u[i] k[i], exp(logw[i]), k[i])
  __shared__ float4 tok[2][D];
  const int j = threadIdx.x;     // the value column this thread owns
  const int bh = blockIdx.x;     // b * H + h
  const int64_t base = (int64_t)bh * S * D + j;
  const float uj = u[(bh % H) * D + j];

  float state[D];                // state[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < D; ++i) state[i] = 0.f;

  float nr = r[base], nk = k[base], nv = v[base], nlw = logw[base];
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    tok[buf][j] = make_float4(nr, uj * nk, expf(nlw), nk);
    const float vj = nv;
    if (t + 1 < S) {             // prefetch the next token
      const int64_t off = base + (int64_t)(t + 1) * D;
      nr = r[off];
      nk = k[off];
      nv = v[off];
      nlw = logw[off];
    }
    // Double buffering makes one barrier per token enough: a thread that
    // writes tok[buf] again at t + 2 has passed the barrier of t + 1, so
    // every thread has finished reading tok[buf] at t.
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float4 x = tok[buf][i];
      const float s = state[i];
      acc[i & 3] = fmaf(x.x, fmaf(x.y, vj, s), acc[i & 3]);
      state[i] = fmaf(x.z, s, x.w * vj);
    }
    o[base + (int64_t)t * D] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  float* sf = s_final + (int64_t)bh * D * D + j;
#pragma unroll
  for (int i = 0; i < D; ++i) sf[i * D] = state[i];
}

template <int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, void* o, void* s_final,
                   int B, int H, int S, cudaStream_t stream) {
  wkv6_fwd_kernel<D><<<B * H, D, 0, stream>>>(
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
