// Forward flash attention for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py, over its whole contract: causal or
// full attention, a sliding window, a logit softcap, GQA/MQA (q head h reads
// kv head h / (Hq/Hkv), no KV copy), ragged Sq and Sk, fp32 running max, sum
// and accumulator, output in q's dtype, f32 or bf16 inputs, head_dim
// 16/32/64/128/256.
//
// What bounds it on the H100: at the prefill shapes of the models (S in the
// thousands, D 64..256) attention does hundreds of operations per byte, so
// it is bound by arithmetic.  This first version does that arithmetic in
// fp32 on the CUDA cores (67 TFLOP/s peak) and not on the tensor cores
// (989 TFLOP/s bf16), so it stays well above the bound; wgmma, TMA and warp
// specialisation are later work.  What the design does about the rest:
//   * One block owns one (b, h, 64-row q tile) and loops over the kv tiles
//     itself: on Hopper blocks run in no order, so the Pallas grid's
//     sequential kv axis (m/l/acc carried in VMEM scratch) becomes this loop,
//     and m, l and acc live in registers for the whole loop.
//   * The loop bounds replace the Pallas `live` guard: with `causal` the loop
//     stops after the tile holding the q tile's last real row; with `window`
//     it starts at the first tile that the q tile's first row can still see.
//     Heavy (late) causal q tiles are scheduled first.
//   * Ragged edges are masked in the kernel (K rows past Sk read as zero and
//     score -1e30; q rows past Sq are never written), so the wrapper makes no
//     padded copies.  Strides come from the wrapper, so the model layout
//     (B, S, H, D) is read in place.
//   * Q (pre-scaled), the current K or V tile and the probabilities sit in
//     dynamic shared memory as fp32; at D=256 that is ~105 KB, above the
//     48 KB of static shared memory, hence cudaFuncSetAttribute.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int THREADS = 256;   // 16 x 16 threads
constexpr int RM = 4;          // q rows per thread (BQ = 16 * RM)
constexpr int PS = BQ + 4;     // padded row of the probability tile
constexpr float NEG_INF = -1e30f;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;  // elements in one 16-byte load
  __device__ static void load(const float* p, float* out) {
    float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  __device__ static float store(float x) { return x; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

struct Params {
  const void* q; const void* k; const void* v; void* o;
  int Hq, Hkv, Sq, Sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale; int causal; int window; float softcap;
};

// smem: Qs [D][BQ] (q^T, pre-scaled) | KV [D][BK] (k^T) or [BK][D] (v) | Ps [BK][PS] (p^T)
template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  constexpr int VN = Vec<T>::N;
  constexpr int CN = BK / 16;  // score columns per thread
  constexpr int DN = D / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KV = Qs + D * BQ;
  float* Ps = KV + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // late causal tiles carry more work
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Q tile, transposed and scaled; rows past Sq read as zero.
  for (int idx = tid; idx < BQ * (D / VN); idx += THREADS) {
    const int r = idx % BQ, d0 = (idx / BQ) * VN;
    float x[VN];
    if (q0 + r < p.Sq) {
      Vec<T>::load(qb + (long long)(q0 + r) * p.q_ss + d0, x);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) Qs[(d0 + i) * BQ + r] = x[i] * p.scale;
  }

  const int n_kt = (p.Sk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kt_end = n_kt;
  if (p.causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) kt_begin = (q0 - p.window + 1) / BK;

  float acc[RM][DN];
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF; l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DN; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P.V is done with KV and Ps
    for (int idx = tid; idx < BK * (D / VN); idx += THREADS) {
      const int c = idx % BK, d0 = (idx / BK) * VN;
      float x[VN];
      if (k0 + c < p.Sk) {
        Vec<T>::load(kb + (long long)(k0 + c) * p.k_ss + d0, x);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) KV[(d0 + i) * BK + c] = x[i];
    }
    __syncthreads();

    // S = (scale q) k^T: rows ty*RM + i, columns tx + 16*j.
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[d * BQ + ty * RM]);
      const float qr[RM] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float kv = KV[d * BK + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) s[i][j] = fmaf(qr[i], kv, s[i][j]);
      }
    }

    // softcap, then mask, then the online softmax.  The 16 threads that
    // share a row are 16 lanes of one warp, so row reductions are shuffles.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + ty * RM + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kp < p.Sk;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DN; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // everyone is done reading k^T from KV

    for (int idx = tid; idx < BK * (D / VN); idx += THREADS) {
      const int c = idx / (D / VN), d0 = (idx % (D / VN)) * VN;
      float x[VN];
      if (k0 + c < p.Sk) {
        Vec<T>::load(vb + (long long)(k0 + c) * p.v_ss + d0, x);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; i += 4)
        *reinterpret_cast<float4*>(&KV[c * D + d0 + i]) =
            make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    }
#pragma unroll
    for (int j = 0; j < CN; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * PS + ty * RM]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V: rows ty*RM + i, columns tx + 16*c.
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[j * PS + ty * RM]);
      const float pr[RM] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        const float vv = KV[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty * RM + i;
    if (r >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + (long long)r * p.o_ss;
#pragma unroll
    for (int c = 0; c < DN; ++c) orow[tx + 16 * c] = Vec<T>::store(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int BK = D >= 256 ? 32 : 64;  // keeps two blocks on an SM at D=256
  const size_t smem = (size_t)(D * BQ + BK * D + BK * PS) * sizeof(float);
  auto kern = flash_fwd_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements; the last dim of
// every tensor is contiguous.  window <= 0 means none; softcap <= 0 means
// none.  Returns the cudaError_t of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        float scale, int causal, int window, float softcap,
                        void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  Params p{q, k, v, o, Hq, Hkv, Sq, Sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           scale, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, D, s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
