// The WKV6 recurrence (RWKV-6 "Finch" time mixing) for Hopper (sm_90a),
// bound to PyTorch with ctypes.
//
// Replaces the Pallas TPU kernel `_wkv6_kernel` / `wkv6` in
// src/repro/kernels/rwkv6_wkv.py, over its whole contract: per (batch, head),
// with the state S (K x V) in fp32,
//     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T
// r/k/v in f32 or bf16, log_w/u/s0 in f32; y comes out in r's dtype (or in
// f32 from bf16 r/k/v, as the JAX rwkv6 model keeps y up to its group norm)
// and the final state in f32.  Any T >= 1 (prefill, ragged lengths, the decode step
// T = 1); K = V in {16, 32, 64}.
//
// What bounds it on the H100: every input is read once and every output
// written once, with ~4 K V fp32 operations per token and head.  At the
// serving shape of rwkv6-1.6b (B=4, H=32, T=1024, K=V=64, bf16) the bytes
// (~105 MB) and the operations (~2.1 GFLOP on the fp32 CUDA cores) each take
// about 0.03 ms.  What keeps this first version above that is the sequential
// loop over T: one (b, h) pair is a chain of T dependent state updates, and
// B*H = 128 pairs give about one block per SM.  The TPU kernel's chunked
// form (decays inside a chunk as matrix products) maps onto `wgmma` and is
// later work.  What the design does:
//   * One block per (b, h) owns the whole sequence, so the Pallas grid's
//     sequential chunk axis (S carried in VMEM scratch) becomes a loop in
//     the block, and S lives in registers throughout: thread (j, s) holds
//     column j, rows s, s + KS, s + 2 KS, ... (16 rows).  The KS threads of a
//     column are neighbouring lanes and sum y_t[j] with shuffles; the
//     interleaved rows put one warp's shared-memory reads on distinct banks
//     (or one broadcast address).
//   * The Pallas chunk of C tokens becomes a chunk of CT tokens staged in
//     shared memory as f32 (w = exp(log_w) taken once per element).  The next
//     chunk's loads are issued into registers before the current chunk is
//     computed, so device-memory latency overlaps the recurrence.
//   * S is only ever multiplied by exp of a non-positive number, so nothing
//     overflows at log_w = -50 (the TPU kernel's exp-of-non-positive rule).
//   * Strides come from the wrapper, so the model layout (B, T, H, K) is read
//     and y written in place; the tail of a ragged last chunk is never
//     computed.  The final state may be written over s0 (the layer's cache):
//     each thread reads its own entries of s0 before it writes them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;  // state rows held by one thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* r; const void* k; const void* v; const float* lw;
  const float* u; const float* s0; void* y; float* s_out;
  int H, T;
  long long r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st;
  long long w_sb, w_sh, w_st, y_sb, y_sh, y_st;
};

// T: the type of r, k and v; TY: the type of y.
template <typename T, typename TY, int K>
__global__ void __launch_bounds__(K * K / ROWS)
wkv6_kernel(const Params p) {
  constexpr int KS = K / ROWS;           // threads per state column
  constexpr int THREADS = K * KS;
  constexpr int CT = K / 2;              // tokens per staged chunk
  constexpr int PER = CT * K / THREADS;  // elements of each array a thread stages (8)
  __shared__ float Rs[CT][K], Ks[CT][K], Vs[CT][K], Ws[CT][K];

  const int tid = threadIdx.x;
  const int j = tid / KS, s = tid % KS;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* rb = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wb = p.lw + b * p.w_sb + h * p.w_sh;
  TY* yb = static_cast<TY*>(p.y) + b * p.y_sb + h * p.y_sh;
  const long long st = ((long long)b * p.H + h) * K * K;  // s0, s_out: contiguous (B, H, K, V)

  float S[ROWS], uu[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = i * KS + s;
    S[i] = p.s0[st + row * K + j];
    uu[i] = p.u[h * K + row];
  }

  // The staging registers: element e of this thread is token e*KS + tid/K of
  // the chunk, channel tid % K (neighbouring threads read neighbouring bytes).
  T pr[PER], pk[PER], pv[PER];
  float pw[PER];
  const int c_of = tid % K, t_of = tid / K;
  auto fetch = [&](int t0) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const long long t = t0 + e * KS + t_of;
      if (t < p.T) {
        pr[e] = rb[t * p.r_st + c_of];
        pk[e] = kb[t * p.k_st + c_of];
        pv[e] = vb[t * p.v_st + c_of];
        pw[e] = wb[t * p.w_st + c_of];
      } else {
        pr[e] = from_float<T>(0.f);
        pk[e] = from_float<T>(0.f);
        pv[e] = from_float<T>(0.f);
        pw[e] = 0.f;
      }
    }
  };

  const int n_chunks = (p.T + CT - 1) / CT;
  fetch(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * CT;
    __syncthreads();  // the previous chunk is done with the staging arrays
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int tt = e * KS + t_of;
      Rs[tt][c_of] = to_float(pr[e]);
      Ks[tt][c_of] = to_float(pk[e]);
      Vs[tt][c_of] = to_float(pv[e]);
      Ws[tt][c_of] = expf(pw[e]);
    }
    __syncthreads();
    if (c + 1 < n_chunks) fetch(t0 + CT);  // in flight while this chunk runs

    const int n = min(CT, p.T - t0);
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      const float vj = Vs[tt][j];
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int i = 0; i < ROWS; i += 2) {
        const int r0 = i * KS + s, r1 = r0 + KS;
        const float kv0 = Ks[tt][r0] * vj;
        const float kv1 = Ks[tt][r1] * vj;
        y0 = fmaf(Rs[tt][r0], fmaf(uu[i], kv0, S[i]), y0);
        y1 = fmaf(Rs[tt][r1], fmaf(uu[i + 1], kv1, S[i + 1]), y1);
        S[i] = fmaf(Ws[tt][r0], S[i], kv0);
        S[i + 1] = fmaf(Ws[tt][r1], S[i + 1], kv1);
      }
      float y = y0 + y1;
#pragma unroll
      for (int off = KS / 2; off > 0; off >>= 1)
        y += __shfl_xor_sync(0xffffffffu, y, off);
      if (s == 0) yb[(long long)(t0 + tt) * p.y_st + j] = from_float<TY>(y);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) p.s_out[st + (i * KS + s) * K + j] = S[i];
}

template <typename T, typename TY, int K>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid(p.H, B);
  wkv6_kernel<T, TY, K><<<grid, K * K / ROWS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TY>
cudaError_t dispatch(const Params& p, int B, int K, cudaStream_t stream) {
  switch (K) {
    case 16: return launch<T, TY, 16>(p, B, stream);
    case 32: return launch<T, TY, 32>(p, B, stream);
    case 64: return launch<T, TY, 64>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 r, k, v and y; 1 = bfloat16 r, k, v and y; 2 = bfloat16
// r, k, v and float32 y.  log_w, u, s0 and s_out are float32.  Strides in elements over (B, H, T) for r, k, v, log_w
// and y, whose last dim is contiguous; u (H, K), s0 and s_out (B, H, K, K)
// are contiguous, and s_out may be s0.  Returns the cudaError_t of the
// launch (0 on success).
int wkv6_fwd(const void* r, const void* k, const void* v, const void* log_w,
             const void* u, const void* s0, void* y, void* s_out,
             int dtype, int B, int H, int T, int K,
             long long r_sb, long long r_sh, long long r_st,
             long long k_sb, long long k_sh, long long k_st,
             long long v_sb, long long v_sh, long long v_st,
             long long w_sb, long long w_sh, long long w_st,
             long long y_sb, long long y_sh, long long y_st,
             void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  Params p{r, k, v, static_cast<const float*>(log_w), static_cast<const float*>(u),
           static_cast<const float*>(s0), y, static_cast<float*>(s_out), H, T,
           r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
           w_sb, w_sh, w_st, y_sb, y_sh, y_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, float>(p, B, K, s);
  if (dtype == 1) return dispatch<__nv_bfloat16, __nv_bfloat16>(p, B, K, s);
  if (dtype == 2) return dispatch<__nv_bfloat16, float>(p, B, K, s);
  return cudaErrorInvalidValue;
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
