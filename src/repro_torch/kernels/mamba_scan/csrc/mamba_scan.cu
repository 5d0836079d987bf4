// Mamba-1 selective scan forward for NVIDIA Hopper, sm_90a.
//
// Replaces no Pallas kernel: the reference computes the scan with
// `lax.associative_scan` over chunks (src/repro/models/layers.py::
// _mamba_ssm_chunked), and the port's plain form (../ref.py) with a
// doubling scan over (B, c, I, N) float32 tensors, chunk by chunk. The
// function, from h0, for every row b, inner channel i and state n:
//
//     h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t
//     y_t = C_t . h_t
//
// returning y and the final state h_S.
//
// Layout: dt, xin and y (B,S,I); A (I,N); Bm, Cm (B,S,N); h0 and h_final
// (B,I,N); all contiguous. dt, xin, Bm and Cm are float32 or all four
// bfloat16 (the model's dtype: widened on reading, so the arithmetic is that
// of their float32 copies); A, h0, y and h_final are float32. N = 16, the
// d_state of every Mamba configuration of the port; S and I are any
// positive sizes (I even for bfloat16).
//
// What bounds it on the H100. At jamba-v0.1-52b's prefill (B 4, S 4096,
// I 8192, N 16) it reads dt and xin, 268 MB each in bfloat16 (537 MB in
// float32), writes y, 537 MB, and reads Bm and Cm, under 1 MB each: 1.07
// GB, 0.32 ms at 3.35 TB/s (1.6 GB, 0.48 ms in float32). It takes B S I N =
// 2.1e9 exponentials, one MUFU.EX2 each among a few FMAs: about 0.5 ms at
// 16 a cycle an SM on 132 SMs (computed, not measured). The doubling form
// moved about 55 GB a chunk of 256 tokens instead.
//
// Design. There are B I N independent recurrences (524,288 at that
// shape), each sequential in t; the kernel keeps them sequential and keeps
// every state in a register:
//
// - A block takes CH = 32 neighbouring channels of one row, LANES = 4
//   threads a channel; lane l holds the four states 4 l .. 4 l + 3 of its
//   channel and their entries of A. 128 threads; B * ceil(I / 32) blocks
//   (1,024 at jamba's shape, 8 a SM fit).
// - Tokens go in chunks of T = 32. Chunk k + 1 of dt, xin (T x CH each,
//   consecutive threads on consecutive channels) and of Bm, Cm (T x N
//   each) is copied by cp.async, in 4-byte pieces (one float or two
//   bfloat16; coalesced, zero-filled past I or S), into the other of two
//   stages while chunk k computes.
// - A token: dt and x of the channel and the lane's four entries of B_t
//   and C_t from shared memory (broadcasts), exp(dt A) with expf (the
//   accurate one, not __expf), the state update as one FMA a state, the
//   lane's part of y_t, and the four lanes' parts summed by two shuffles;
//   lane 0 stores y_t in shared memory, and the chunk's y leaves in
//   coalesced stores after it. h_final is written once, at the end.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro_torch;
using namespace repro_torch::sm90;

constexpr int N = 16;       // states a channel (d_state)
constexpr int CH = 32;      // channels a block
constexpr int LANES = 4;    // threads a channel
constexpr int NS = N / LANES;   // states a thread
constexpr int T = 32;       // tokens a chunk
constexpr int THREADS = CH * LANES;
constexpr int STAGES = 2;
constexpr int XT = T * CH;  // elements of a chunk of dt or xin
constexpr int BT = T * N;   // elements of a chunk of Bm or Cm
constexpr int STAGE = 2 * XT + 2 * BT;

// A lane's four neighbouring elements of shared memory as floats (16-byte
// aligned floats, 8-byte aligned bfloat16).
__device__ __forceinline__ void load_states(const float* p, float (&x)[NS]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}
__device__ __forceinline__ void load_states(const __nv_bfloat16* p,
                                            float (&x)[NS]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

template <typename TI>
__global__ void __launch_bounds__(THREADS)
mamba_scan_fwd_kernel(const TI* __restrict__ dt, const float* __restrict__ A,
                      const TI* __restrict__ Bm, const TI* __restrict__ Cm,
                      const TI* __restrict__ xin,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_final, int S, int I) {
  constexpr int EP = 4 / sizeof(TI);       // elements a 4-byte copy
  __shared__ __align__(16) unsigned char raw[STAGES * STAGE * sizeof(TI)];
  __shared__ float sY[XT];
  TI* smem = reinterpret_cast<TI*>(raw);

  const int tid = threadIdx.x;
  const int ch = tid / LANES;              // the channel in the block
  const int lane = tid % LANES;
  const int c0 = blockIdx.x * CH;
  const int b = blockIdx.y;
  const int i = c0 + ch;                   // the channel
  const bool live = i < I;
  const int nchunks = (S + T - 1) / T;

  // chunk k of dt, xin, Bm and Cm into its stage
  auto load_chunk = [&](int k) {
    if (k < nchunks) {
      TI* sDt = smem + (k % STAGES) * STAGE;
      TI* sX = sDt + XT;
      TI* sB = sX + XT;
      TI* sC = sB + BT;
      const int t0 = k * T;
      // a piece holds EP neighbouring channels (I is even for EP = 2)
      for (int e = tid * EP; e < XT; e += THREADS * EP) {
        const int t = e / CH;
        const int c = e - t * CH;
        const bool ok = t0 + t < S && c0 + c < I;
        const int64_t off = ok ? ((int64_t)b * S + t0 + t) * I + c0 + c : 0;
        cp_async4(sDt + e, dt + off, ok);
        cp_async4(sX + e, xin + off, ok);
      }
      // the chunk's T x N is contiguous; no piece straddles two tokens
      for (int e = tid * EP; e < BT; e += THREADS * EP) {
        const bool ok = t0 + e / N < S;
        const int64_t off = ok ? ((int64_t)b * S + t0) * N + e : 0;
        cp_async4(sB + e, Bm + off, ok);
        cp_async4(sC + e, Cm + off, ok);
      }
    }
    cp_async_commit();
  };

  float a[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = lane * NS + j;
    a[j] = live ? A[(int64_t)i * N + n] : 0.f;
    h[j] = live ? h0[((int64_t)b * I + i) * N + n] : 0.f;
  }

  load_chunk(0);
  for (int k = 0; k < nchunks; ++k) {
    load_chunk(k + 1);  // its stage held chunk k - 1, done at the last barrier
    cp_async_wait<1>();
    __syncthreads();  // chunk k is in; sY was written out
    const TI* sDt = smem + (k % STAGES) * STAGE;
    const TI* sX = sDt + XT;
    const TI* sB = sX + XT;
    const TI* sC = sB + BT;
    const int n = min(T, S - k * T);

#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float d = to_f32(sDt[t * CH + ch]);
      const float dx = d * to_f32(sX[t * CH + ch]);
      float bv[NS], cv[NS];
      load_states(sB + t * N + lane * NS, bv);
      load_states(sC + t * N + lane * NS, cv);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        h[j] = fmaf(expf(d * a[j]), h[j], dx * bv[j]);
        part = fmaf(cv[j], h[j], part);
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) sY[t * CH + ch] = part;
    }
    __syncthreads();  // sY is in; the stage may be refilled

    float* yg = y + ((int64_t)b * S + (int64_t)k * T) * I + c0;
    for (int e = tid; e < n * CH; e += THREADS) {
      const int t = e / CH;
      const int c = e - t * CH;
      if (c0 + c < I) yg[(int64_t)t * I + c] = sY[e];
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      h_final[((int64_t)b * I + i) * N + lane * NS + j] = h[j];
  }
}

template <typename TI>
cudaError_t launch(const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* xin, const void* h0, void* y,
                   void* h_final, int B, int S, int I, cudaStream_t stream) {
  const dim3 grid((I + CH - 1) / CH, B);
  mamba_scan_fwd_kernel<TI><<<grid, THREADS, 0, stream>>>(
      static_cast<const TI*>(dt), static_cast<const float*>(A),
      static_cast<const TI*>(Bm), static_cast<const TI*>(Cm),
      static_cast<const TI*>(xin), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h_final), S, I);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 when the launch was accepted. dt, Bm, Cm and
// xin are of `dtype` (common.cuh's codes: kF32 or kBF16), the other
// pointers float32.
int mamba_scan_fwd(const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* xin, const void* h0, void* y,
                   void* h_final, int B, int S, int I, int N, int dtype,
                   void* stream) {
  if (B <= 0 || S <= 0 || I <= 0 || B > 65535 || N != 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro_torch::kF32:
      return launch<float>(dt, A, Bm, Cm, xin, h0, y, h_final, B, S, I, st);
    case repro_torch::kBF16:
      if (I % 2) return cudaErrorInvalidValue;
      return launch<__nv_bfloat16>(dt, A, Bm, Cm, xin, h0, y, h_final, B, S,
                                   I, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
