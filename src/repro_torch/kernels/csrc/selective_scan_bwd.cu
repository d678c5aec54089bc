// The backward pass of the Mamba-1 (S6) selective scan for Hopper
// (sm_90a), bound to PyTorch with ctypes.
//
// It replaces no TPU kernel: the JAX package leaves the scan and its
// gradient to XLA (src/repro/models/ssm.py, `associative_scan` in chunks of
// 64 tokens).  It was added so that jamba trains: autograd through the
// plain doubling scan keeps (B, 64, d_in, N) fp32 tensors per chunk, per
// doubling level and per layer.
//
// With the forward (selective_scan.cu)
//     a_t = exp(dt_t A),  h_t = a_t h_{t-1} + dtx_t B_t,  y_t = sum_n h_t C_t
// and the gradients dy of y and dh of h_S, the gradient of h_t is
//     G_t = C_t dy_t + a_{t+1} G_{t+1},    G_S-1 = C_S-1 dy_S-1 + dh,
// and, with da_t = G_t h_{t-1} (the gradient of a_t),
//     ddt_t[d]  = sum_n da_t a_t A            ddtx_t[d] = sum_n G_t B_t
//     dB_t[n]   = sum_d G_t dtx_t             dC_t[n]   = sum_d dy_t h_t
//     dA[d, n]  = sum_{b,t} da_t a_t dt_t     dh0       = a_0 G_0.
// The plain version is `ref.selective_scan_backward_reference`.
//
// What bounds it on the H100: bytes.  It reads dt, dtx and dy and writes
// ddt and ddtx, (B, S, d_in) fp32 each, and reads the forward's saved
// states hs (B, S / 64, d_in, N): 1.41 GB at jamba's training shape
// (B 4, S 1024, d_in 16384, N 16), 0.42 ms at 3.35 TB/s.
//
// Design (a first, simple kernel), two launches:
//   1. `selective_scan_bwd_kernel`: a thread owns one state (b, d, n), N
//      lanes of a warp one channel, a block of BWD_THREADS threads
//      BWD_THREADS / N channels of one row at a time, over `passes` such
//      groups of channels in turn.  The chunks of CHUNK tokens are walked in
//      reverse: each is first run forward again from its saved state, its
//      CHUNK states kept in registers (no division by a decay), then walked
//      back, carrying G.  ddt and ddtx are summed over the channel's N lanes
//      by shuffles; dA accumulates in a register over the tokens; dB and dC
//      are summed over the warp's channels by shuffles, then over the
//      block's warps in order through shared memory once a chunk, and added
//      to the block's fp32 part (G, B, S, 2, N) in pass order.
//   2. `selective_scan_bwd_sum_kernel`: dB and dC as the parts summed over
//      the G blocks in order, dA as the rows' parts summed in order.
// No float atomics: two calls give bit-identical gradients.
#include <cuda_runtime.h>

namespace {

constexpr int BWD_THREADS = 256;
constexpr int WARPS = BWD_THREADS / 32;
constexpr int CHUNK = 64;  // tokens between the forward's saved states
constexpr int SUM_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* dt;   // (B, S, D)
  const float* dtx;  // (B, S, D)
  const float* bm;   // (B, S, N)
  const float* cm;   // (B, S, N)
  const float* a;    // (D, N)
  const float* hs;   // (B, nc, D, N): the state before each chunk
  const float* dy;   // (B, S, D)
  const float* dh;   // (B, D, N) or null: the gradient of h_S
  float* ddt;        // (B, S, D)
  float* ddtx;       // (B, S, D)
  float* dh0;        // (B, D, N)
  float* da_part;    // (B, D, N): dA of each row
  float* dbc_part;   // (G, B, S, 2, N): dB and dC of each block
  int B, S, D, passes;
};

template <int N>
__global__ void __launch_bounds__(BWD_THREADS) selective_scan_bwd_kernel(Params p) {
  extern __shared__ float smem[];  // [WARPS][CHUNK][2][N]: the warps' dB and dC
  constexpr int CPB = BWD_THREADS / N;  // channels a pass
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = tid % N, ch = tid / N;
  const int b = blockIdx.y, g = blockIdx.x;
  const long long D = p.D, S = p.S;
  const int nc = (p.S + CHUNK - 1) / CHUNK;
  for (int pass = 0; pass < p.passes; ++pass) {
    const int d0 = (g * p.passes + pass) * CPB + ch;
    const bool live = d0 < p.D;
    const int d = live ? d0 : 0;  // a dead lane reads in bounds and adds zeros
    const float av = __ldg(p.a + (long long)d * N + n);
    float carry = (live && p.dh != nullptr) ? __ldg(p.dh + (b * D + d) * N + n) : 0.f;
    float da_acc = 0.f;
    for (int c = nc - 1; c >= 0; --c) {
      const int t0 = c * CHUNK, len = min(CHUNK, p.S - t0);
      const float hstart = __ldg(p.hs + ((b * nc + c) * D + d) * N + n);
      const long long row = (b * S + t0) * D + d;
      const long long rown = (b * S + t0) * N + n;
      float hbuf[CHUNK];
      float h = hstart;
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        if (i < len) {
          h = expf(__ldg(p.dt + row + i * D) * av) * h +
              __ldg(p.dtx + row + i * D) * __ldg(p.bm + rown + i * N);
          hbuf[i] = h;
        }
      }
#pragma unroll
      for (int i = CHUNK - 1; i >= 0; --i) {
        if (i < len) {
          // read-only loads (__ldg): they may be issued ahead of the stores of
          // ddt and ddtx, which the compiler cannot otherwise tell apart
          const float dtv = __ldg(p.dt + row + i * D), xv = __ldg(p.dtx + row + i * D);
          const float dyv = __ldg(p.dy + row + i * D);
          const float bv = __ldg(p.bm + rown + i * N), cv = __ldg(p.cm + rown + i * N);
          const float at = expf(dtv * av);
          const float gt = cv * dyv + carry;
          const float hp = i > 0 ? hbuf[i - 1] : hstart;
          const float da = gt * hp * at;  // the gradient of dt A
          float gdt = live ? da * av : 0.f;
          float gdx = live ? gt * bv : 0.f;
          float gb = live ? gt * xv : 0.f;
          float gc = live ? dyv * hbuf[i] : 0.f;
          if (live) da_acc += da * dtv;
#pragma unroll
          for (int o = N / 2; o > 0; o >>= 1) {  // over the channel's states
            gdt += __shfl_xor_sync(FULL, gdt, o);
            gdx += __shfl_xor_sync(FULL, gdx, o);
          }
#pragma unroll
          for (int o = N; o < 32; o <<= 1) {  // over the warp's channels
            gb += __shfl_xor_sync(FULL, gb, o);
            gc += __shfl_xor_sync(FULL, gc, o);
          }
          if (live && n == 0) {
            p.ddt[row + i * D] = gdt;
            p.ddtx[row + i * D] = gdx;
          }
          if (lane < N) {
            smem[((warp * CHUNK + i) * 2 + 0) * N + n] = gb;
            smem[((warp * CHUNK + i) * 2 + 1) * N + n] = gc;
          }
          carry = at * gt;
        }
      }
      __syncthreads();
      // the chunk's dB and dC over the block's warps, in order, into its part
      float* part = p.dbc_part + (((long long)g * p.B + b) * S + t0) * 2 * N;
      for (int e = tid; e < len * 2 * N; e += BWD_THREADS) {
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += smem[w * CHUNK * 2 * N + e];
        part[e] = pass == 0 ? s : part[e] + s;
      }
      __syncthreads();
    }
    if (live) {
      p.dh0[(b * D + d) * N + n] = carry;
      p.da_part[(b * D + d) * N + n] = da_acc;
    }
  }
}

__global__ void __launch_bounds__(SUM_THREADS)
selective_scan_bwd_sum_kernel(const float* dbc_part, const float* da_part, float* db, float* dc,
                              float* da, int G, int B, int S, int D, int N) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  const long long nbc = (long long)B * S * 2 * N, nda = (long long)D * N;
  if (i < nbc) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += __ldg(dbc_part + g * nbc + i);
    const long long bt = i / (2 * N), k = (i / N) % 2, n = i % N;
    (k == 0 ? db : dc)[bt * N + n] = s;
  } else if (i < nbc + nda) {
    const long long j = i - nbc;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += __ldg(da_part + b * nda + j);
    da[j] = s;
  }
}

template <int N>
cudaError_t launch(const Params& p, int groups, float* db, float* dc, float* da,
                   cudaStream_t stream) {
  const int smem = WARPS * CHUNK * 2 * N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(selective_scan_bwd_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  selective_scan_bwd_kernel<N><<<dim3(groups, p.B), BWD_THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)p.B * p.S * 2 * N + (long long)p.D * N;
  selective_scan_bwd_sum_kernel<<<(total + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                                  stream>>>(p.dbc_part, p.da_part, db, dc, da, groups, p.B, p.S,
                                            p.D, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The channels one block takes a pass: BWD_THREADS / N.
int selective_scan_bwd_channels(int N) { return BWD_THREADS / N; }

// All tensors float32 and contiguous: dt, dtx, dy, ddt and ddtx (B, S, D);
// bm, cm, db and dc (B, S, N); a and da (D, N); hs (B, ceil(S / 64), D, N),
// the forward's saved states; dh (null: zero), dh0 and da_part (B, D, N);
// dbc_part (groups, B, S, 2, N) scratch.  N in {4, 8, 16}; groups * passes
// * BWD_THREADS / N >= D.  Two launches on `stream`; returns the first
// cudaError_t that is not 0, else 0.
int selective_scan_bwd(const float* dt, const float* dtx, const float* bm, const float* cm,
                       const float* a, const float* hs, const float* dy, const float* dh,
                       float* ddt, float* ddtx, float* db, float* dc, float* da, float* dh0,
                       float* da_part, float* dbc_part, int B, int S, int D, int N, int groups,
                       int passes, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || groups <= 0 || passes <= 0) return cudaErrorInvalidValue;
  if (N != 4 && N != 8 && N != 16) return cudaErrorInvalidValue;
  if ((long long)groups * passes * (BWD_THREADS / N) < D) return cudaErrorInvalidValue;
  Params p{dt, dtx, bm, cm, a, hs, dy, dh, ddt, ddtx, dh0, da_part, dbc_part, B, S, D, passes};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(p, groups, db, dc, da, s);
    case 8: return launch<8>(p, groups, db, dc, da, s);
    default: return launch<16>(p, groups, db, dc, da, s);
  }
}

const char* selective_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
