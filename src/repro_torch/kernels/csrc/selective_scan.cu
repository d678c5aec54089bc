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
// doubling scan, whose sums run in another order); this kernel's order is
// mirrored by `ref.selective_scan_chunked_reference`.  No decay-ratio
// division: the decays are formed as exp(dt A) token by token, as in JAX.
//
// What bounds it on the H100.  Bytes: it reads dt and dtx and writes y,
// (B, S, d_in) fp32 each, and reads B_t, C_t and h0, writes h_S: 815.3 MB
// at jamba's prefill (B 4, S 1024, d_in 16384, N 16), 0.2434 ms at
// 3.35 TB/s.  Operations: one full-precision exponential a token and state
// (1.07 G there: 0.26-0.29 ms on the SMs' exp units, and some 8
// instructions each with its range reduction) and three fp32 operations,
// so issue (~0.4 ms) sits above the bytes.  An approximate exponential
// (`__expf`) would cut it, but misses the 1e-5 bound at decays near 1
// (1024 decays of ~0.999 compound its bias): tools/selective_scan_ablation.py.
//
// What the first design (a thread a channel, its N states in registers)
// lost: 0.80 ms at that shape, and 0.65 ms at a quarter of the work (4096
// channels, one block of 4 warps on each SM).  Its dt and dtx came straight
// from device memory in the walk, a few loads in flight a thread.
//
// This design: a thread holds SPT states of one channel (8 at N 16: 2
// lanes a channel, whose y is summed by one shuffle), so a scan has twice
// the threads of a thread a channel at half the registers; each SUB-token
// stage's dt and dtx (its tokens x the block's channels) and B_t, C_t are
// copied to shared memory by 16-byte `cp.async` (4-byte where d_in % 4 !=
// 0) in two stages, the next stage's in flight while this one is walked.
// A decode step (S = 1) is the same kernel with one token, 4 states a
// thread; the state may be updated in place (h_out == h0): each thread
// reads its states before it writes them.
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 64;  // tokens between the states kept for the backward (JAX's chunk)
constexpr int SUB = 16;    // tokens a stage
constexpr int BT = 128;    // threads a block
constexpr unsigned FULL = 0xffffffffu;
static_assert(CHUNK % SUB == 0, "a saved state starts a stage");

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
  bool vec;  // D % 4 == 0: rows staged in 16-byte pieces
};

__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  // 4 bytes, or zeros when `valid` is false (src is then not read)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp16(float* dst, const float* src, int bytes) {
  // 16 bytes, the last 16 - `bytes` of them zeros; src 16-byte aligned
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Stage k (tokens k*SUB ..) of row b for the block's channels g*CPB ..: dt,
// dtx [SUB][CPB], B, C [SUB][N]; zeros past S and D, which make a padded
// token an identity step (a = 1, no input).
template <int N, int CPB>
__device__ __forceinline__ void stage(const Params& p, float* st, int b, int g, int k, int tid) {
  const int t0 = k * SUB, len = min(SUB, p.S - t0);
  if (p.vec) {  // D % 4 == 0: rows of 16-byte pieces
    for (int e = tid * 4; e < SUB * CPB; e += BT * 4) {
      const int i = e / CPB, d = g * CPB + e % CPB;
      const int bytes = i < len ? 4 * max(0, min(4, p.D - d)) : 0;
      const long long off = bytes ? ((long long)b * p.S + t0 + i) * p.D + d : 0;
      cp16(st + e, p.dt + off, bytes);
      cp16(st + SUB * CPB + e, p.dtx + off, bytes);
    }
  } else {
    for (int e = tid; e < SUB * CPB; e += BT) {
      const int i = e / CPB, d = g * CPB + e % CPB;
      const bool ok = i < len && d < p.D;
      const long long off = ok ? ((long long)b * p.S + t0 + i) * p.D + d : 0;
      cp4(st + e, p.dt + off, ok);
      cp4(st + SUB * CPB + e, p.dtx + off, ok);
    }
  }
  float* sb = st + 2 * SUB * CPB;
  for (int e = tid * 4; e < SUB * N; e += BT * 4) {  // N % 4 == 0: 16-byte pieces
    const int bytes = e / N < len ? 16 : 0;
    const long long off = bytes ? ((long long)b * p.S + t0) * N + e : 0;
    cp16(sb + e, p.bm + off, bytes);
    cp16(sb + SUB * N + e, p.cm + off, bytes);
  }
}

template <int N, int SPT>
__global__ void __launch_bounds__(BT) selective_scan_fwd_kernel(const Params p) {
  constexpr int LPC = N / SPT;   // lanes a channel
  constexpr int CPB = BT / LPC;  // channels a block
  constexpr int STAGE = 2 * SUB * CPB + 2 * SUB * N;
  extern __shared__ __align__(16) float smem[];  // [2][STAGE]
  const int tid = threadIdx.x;
  const int ch = tid / LPC, n0 = (tid % LPC) * SPT;
  const int g = blockIdx.x, b = blockIdx.y;
  const long long D = p.D, S = p.S;
  const int nk = (p.S + SUB - 1) / SUB, nc = (p.S + CHUNK - 1) / CHUNK;
  const int d = g * CPB + ch;
  const bool live = d < p.D;  // a dead lane computes zeros and stores nothing
  const long long dn = ((long long)b * D + (live ? d : 0)) * N + n0;
  float h[SPT], A[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    h[s] = live ? p.h0[dn + s] : 0.f;  // may be h_out: a plain load
    A[s] = live ? __ldg(p.a + (long long)d * N + n0 + s) : 0.f;
  }
  stage<N, CPB>(p, smem, b, g, 0, tid);
  cp_commit();
  for (int k = 0; k < nk; ++k) {
    const float* st = smem + (k & 1) * STAGE;
    if (k + 1 < nk) stage<N, CPB>(p, smem + ((k + 1) & 1) * STAGE, b, g, k + 1, tid);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    if (p.hs != nullptr && live && k % (CHUNK / SUB) == 0) {
      float* out = p.hs + (((long long)b * nc + k / (CHUNK / SUB)) * D + d) * N + n0;
#pragma unroll
      for (int s = 0; s < SPT; ++s) out[s] = h[s];
    }
    const int t0 = k * SUB, len = min(SUB, p.S - t0);
    const float* sdt = st + ch;
    const float* sdx = st + SUB * CPB + ch;
    const float* sb = st + 2 * SUB * CPB + n0;
    const float* sc = sb + SUB * N;
    float* yp = p.y + ((long long)b * S + t0) * D + d;
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
      const float dtv = sdt[i * CPB], xv = sdx[i * CPB];
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < SPT; ++s) {
        h[s] = expf(dtv * A[s]) * h[s] + xv * sb[i * N + s];
        acc += h[s] * sc[i * N + s];
      }
#pragma unroll
      for (int o = 1; o < LPC; o <<= 1) acc += __shfl_xor_sync(FULL, acc, o);
      if (n0 == 0 && live && i < len) yp[i * D] = acc;
    }
    __syncthreads();  // before the next stage is written over this one
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < SPT; ++s) p.h_out[dn + s] = h[s];
  }
}

template <int N, int SPT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int CPB = BT / (N / SPT);
  constexpr int smem = 2 * (2 * SUB * CPB + 2 * SUB * N) * sizeof(float);
  const int groups = (p.D + CPB - 1) / CPB;
  cudaError_t err = cudaFuncSetAttribute(selective_scan_fwd_kernel<N, SPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  selective_scan_fwd_kernel<N, SPT><<<dim3(groups, p.B), BT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All tensors float32, contiguous and 16-byte aligned: dt, dtx and y (B, S,
// D); bm and cm (B, S, N); a (D, N); h0 and h_out (B, D, N), h_out may be
// h0; hs null or (B, ceil(S / chunk), D, N).  N in {4, 8, 16}; spt (states
// a thread) 8 at N 8 and 16, or 4; chunk must be CHUNK, the backward's.
// One launch on `stream`; returns the first cudaError_t that is not 0,
// else 0.
int selective_scan_fwd(const float* dt, const float* dtx, const float* bm, const float* cm,
                       const float* a, const float* h0, float* y, float* h_out, float* hs,
                       int B, int S, int D, int N, int chunk, int spt, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || chunk != CHUNK) return cudaErrorInvalidValue;
  Params p{dt, dtx, bm, cm, a, h0, y, h_out, hs, B, S, D, D % 4 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N * 32 + spt) {
    case 4 * 32 + 4: return launch<4, 4>(p, s);
    case 8 * 32 + 4: return launch<8, 4>(p, s);
    case 8 * 32 + 8: return launch<8, 8>(p, s);
    case 16 * 32 + 4: return launch<16, 4>(p, s);
    case 16 * 32 + 8: return launch<16, 8>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
