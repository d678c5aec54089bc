// The selective scan of the Mamba-1 (S6) mixer for Hopper (sm_90a), bound
// to PyTorch with ctypes: the forward, and the states the backward
// (selective_scan_bwd.cu) starts its chunks from.
//
// It replaces no TPU kernel: the JAX package computes the scan in XLA
// (src/repro/models/ssm.py `selective_scan` / `chunked_scan`, an
// associative scan in chunks of 64 tokens) and has no Pallas kernel for it.
// It was added because jamba's Mamba layers spent 0.91 of the model's
// prefill in the plain doubling scan (154.6 ms a layer at B 4, S 1024,
// d_in 16384, N 16), and because autograd through that scan keeps
// (B, 64, d_in, N) fp32 tensors per chunk, per doubling level and per
// layer: too much to train.
//
// What it computes, per batch row b, channel d and state n, in fp32 from
// the state h0:
//     h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + dtx_t[d] B_t[n]
//     y_t[d]    = sum_n h_t[d, n] C_t[n]
// returning y (B, S, d_in) and h_S (B, d_in, N); with `hs` it also writes
// the state before every CHUNK-th token, hs[b, c] = h_{c CHUNK - 1} (h0 for
// c = 0): (B, ceil(S / CHUNK), d_in, N), the backward's starting points.
// The plain version is `ref.selective_scan_reference` (JAX's chunked
// doubling scan, whose sums run in another order).  No decay-ratio
// division: the decays are formed as exp(dt A) token by token, as in JAX.
//
// What bounds it on the H100: bytes.  It reads dt and dtx and writes y,
// (B, S, d_in) fp32 each, and reads B_t, C_t and h0, writes h_S: 805.8 MB
// at jamba's prefill (B 4, S 1024, d_in 16384, N 16), 0.2405 ms at
// 3.35 TB/s.  Its operations, one exp and three fp32 operations per token
// and state, 1.07 G of each there, sit at about that time on the SMs'
// exp units.
//
// Design (a first, simple kernel): one thread owns one (b, d) channel with
// its N states in registers and walks the S tokens in order; a block of
// FWD_THREADS channels of one row stages B_t and C_t for FWD_T tokens in
// shared memory (every channel reads them), while dt and dtx are read
// straight from device memory, coalesced across the block's channels.  The
// state never leaves the registers between tokens.  A decode step (S = 1)
// is the same kernel with one token; the state may be updated in place
// (h_out == h0): each thread reads its states before it writes them.
#include <cuda_runtime.h>

namespace {

constexpr int FWD_THREADS = 128;  // channels a block
constexpr int FWD_T = 64;         // tokens of B_t and C_t staged at a time
constexpr int CHUNK = 64;         // tokens between the saved states (the backward's chunk)

struct Params {
  const float* dt;   // (B, S, D)
  const float* dtx;  // (B, S, D)
  const float* bm;   // (B, S, N)
  const float* cm;   // (B, S, N)
  const float* a;    // (D, N)
  const float* h0;   // (B, D, N)
  float* y;          // (B, S, D)
  float* h_out;      // (B, D, N), may be h0
  float* hs;         // (B, ceil(S / CHUNK), D, N) or null
  int B, S, D;
};

template <int N>
__global__ void __launch_bounds__(FWD_THREADS) selective_scan_fwd_kernel(Params p) {
  __shared__ float sb[FWD_T * N];
  __shared__ float sc[FWD_T * N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * FWD_THREADS + threadIdx.x;
  const bool live = d < p.D;
  const long long D = p.D, S = p.S;
  const int nc = (p.S + CHUNK - 1) / CHUNK;
  float h[N], a[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = live ? p.h0[(b * D + d) * N + n] : 0.f;  // may be h_out: a plain load
    a[n] = live ? __ldg(p.a + (long long)d * N + n) : 0.f;
  }
  for (int t0 = 0; t0 < p.S; t0 += FWD_T) {
    const int len = min(FWD_T, p.S - t0);
    __syncthreads();  // the previous tokens' B and C are read
    for (int i = threadIdx.x; i < len * N; i += FWD_THREADS) {
      const long long g = (b * S + t0) * N + i;
      sb[i] = __ldg(p.bm + g);
      sc[i] = __ldg(p.cm + g);
    }
    __syncthreads();
    if (!live) continue;
    const long long row = (b * S + t0) * D + d;
#pragma unroll 4
    for (int i = 0; i < len; ++i) {
      const int t = t0 + i;
      if (p.hs != nullptr && t % CHUNK == 0) {
        float* out = p.hs + ((b * nc + t / CHUNK) * D + d) * N;
#pragma unroll
        for (int n = 0; n < N; ++n) out[n] = h[n];
      }
      // read-only loads (__ldg): they may be issued ahead of the stores of y
      const float dtv = __ldg(p.dt + row + i * D);
      const float xv = __ldg(p.dtx + row + i * D);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * a[n]) * h[n] + xv * sb[i * N + n];
        acc += h[n] * sc[i * N + n];
      }
      p.y[row + i * D] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) p.h_out[(b * D + d) * N + n] = h[n];
  }
}

template <int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.D + FWD_THREADS - 1) / FWD_THREADS, p.B);
  selective_scan_fwd_kernel<N><<<grid, FWD_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All tensors float32 and contiguous: dt, dtx and y (B, S, D); bm and cm
// (B, S, N); a (D, N); h0 and h_out (B, D, N), h_out may be h0; hs null or
// (B, ceil(S / chunk), D, N).  N in {4, 8, 16}; chunk must be 64, the
// backward's.  One launch on `stream`; returns the cudaError_t of the
// launch (0 when it was taken).
int selective_scan_fwd(const float* dt, const float* dtx, const float* bm, const float* cm,
                       const float* a, const float* h0, float* y, float* h_out, float* hs, int B,
                       int S, int D, int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || chunk != CHUNK) return cudaErrorInvalidValue;
  Params p{dt, dtx, bm, cm, a, h0, y, h_out, hs, B, S, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(p, s);
    case 8: return launch<8>(p, s);
    case 16: return launch<16>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
