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
// it is bound by arithmetic, and the arithmetic belongs on the tensor cores
// (989 TFLOP/s bf16 against 67 TFLOP/s fp32 on the CUDA cores).  Two
// kernels share one contract and one set of loop bounds:
//
// bf16 (`flash_fwd_mma_kernel`): the FlashAttention-2 pattern on Ampere-style
// warp-level tensor-core instructions.
//   * One block of 4 warps owns one (b, h, 64-row q tile); each warp owns 16
//     q rows and loops over the kv tiles with its running max, sum and
//     output accumulator in registers (on Hopper blocks run in no order, so
//     the Pallas grid's sequential kv axis, m/l/acc carried in VMEM scratch,
//     becomes this loop).
//   * K and V tiles are copied to shared memory with 16-byte `cp.async`,
//     double-buffered: tile j+1 is in flight while tile j is computed.  Rows
//     past Sk are zero-filled (src-size 0) and scored -1e30.  Shared rows are
//     padded by 16 bytes, so the eight 16-byte rows of an `ldmatrix` read fall
//     on distinct banks at every head_dim.
//   * S = Q K^T with `mma.sync.m16n8k16` (bf16 in, fp32 out); Q and K
//     fragments come from `ldmatrix.x4`, Q re-read from shared memory each kv
//     tile so that at D = 256 the registers go to the 128-float output
//     accumulator.  scale and softcap are applied to the fp32 scores (not
//     folded into a bf16 Q), and masks on fragment coordinates, only in tiles
//     that a mask can touch.
//   * The online softmax runs in registers: a row's scores are spread over
//     the 4 lanes of a quad, so the row max takes two `__shfl_xor_sync`; the
//     row sum stays per lane until the epilogue.
//   * O += P V: P goes to bf16 in registers and is the A operand as it
//     stands (two adjacent m16n8 accumulators are one m16k16 A fragment), so
//     it never touches shared memory; V fragments come from `ldmatrix.trans`
//     of the row-major [BK][D] tile.  P's rounding to bf16 is the one
//     rounding the fp32 plain version does not make (the JAX model path,
//     `sdpa_chunked`, casts P to the compute dtype too).
//   Left on the table, for later work: Hopper's `wgmma` (the only way to the
//   full tensor-core rate; `mma.sync` reaches a fraction of it), TMA loads
//   with `mbarrier`s, and warp specialisation (a producer warp feeding
//   consumer warpgroups).
//
// f32 (`flash_fwd_kernel`): the only tensor-core path for fp32 is TF32,
// which rounds the inputs to 10 bits, so fp32 stays on the CUDA cores, where
// it keeps to within 2e-5 of the fp32 oracle.  16 x 16 threads each own a
// 4-row x (BK/16) strip of scores; Q (pre-scaled), one K or V tile and P sit
// in dynamic shared memory as fp32 (~105 KB at D=256, above the 48 KB of
// static shared memory, hence cudaFuncSetAttribute).
//
// Training (optional): with a non-null `lse` pointer each kernel also writes
// the row log-sum-exp of the scores it normalised, in natural-log units
// after scale and softcap, fp32 (B, Hq, Sq) contiguous; the backward kernel
// (flash_attention_bwd.cu) recomputes P from it.  The serve path passes null
// and writes nothing more.
//
// Shared by both: the loop bounds replace the Pallas `live` guard (with
// `causal` the loop stops after the tile holding the q tile's last real
// row; with `window` it starts at the first tile that the q tile's first row
// can still see), heavy (late) causal q tiles are scheduled first, q rows
// past Sq are never written, and strides come from the wrapper, so the model
// layout (B, S, H, D) is read and written in place with no padded copy.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // q rows per block
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q; const void* k; const void* v; void* o;
  float* lse;  // (B, Hq, Sq) row log-sum-exp, or null
  int Hq, Hkv, Sq, Sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale; int causal; int window; float softcap;
};

// The kv tiles [kt_begin, kt_end) that the q tile starting at row q0 can see.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int BK,
                                         int& kt_begin, int& kt_end) {
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  kt_end = (p.Sk + BK - 1) / BK;
  if (p.causal) kt_end = min(kt_end, q_last / BK + 1);
  kt_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) kt_begin = (q0 - p.window + 1) / BK;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int RM = 4;         // q rows per thread (BQ = 16 * RM)
constexpr int PS = BQ + 4;    // padded row of the probability tile

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

// smem: Qs [D][BQ] (q^T, pre-scaled) | KV [D][BK] (k^T) or [BK][D] (v) | Ps [BK][PS] (p^T)
template <int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  constexpr int VN = 4;        // floats in one 16-byte load
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

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Q tile, transposed and scaled; rows past Sq read as zero.
  for (int idx = tid; idx < BQ * (D / VN); idx += THREADS) {
    const int r = idx % BQ, d0 = (idx / BQ) * VN;
    float x[VN];
    if (q0 + r < p.Sq) {
      load4(qb + (long long)(q0 + r) * p.q_ss + d0, x);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) Qs[(d0 + i) * BQ + r] = x[i] * p.scale;
  }

  int kt_begin, kt_end;
  kv_range(p, q0, BK, kt_begin, kt_end);

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
        load4(kb + (long long)(k0 + c) * p.k_ss + d0, x);
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
        load4(vb + (long long)(k0 + c) * p.v_ss + d0, x);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) x[i] = 0.f;
      }
      *reinterpret_cast<float4*>(&KV[c * D + d0]) = make_float4(x[0], x[1], x[2], x[3]);
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
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.Hq + h) * p.Sq + r] = m[i] + logf(denom);
    float* orow = ob + (long long)r * p.o_ss;
#pragma unroll
    for (int c = 0; c < DN; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr int BK = D >= 256 ? 32 : 64;  // keeps two blocks on an SM at D=256
  const size_t smem = (size_t)(D * BQ + BK * D + BK * PS) * sizeof(float);
  auto kern = flash_fwd_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int MMA_THREADS = 128;  // 4 warps x 16 q rows
constexpr int PAD = 8;            // bf16 elements (16 bytes) of padding per shared row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; with full == false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(ptr)));
}

// c += a b: a 16x16 (row), b 16x8 (col), c 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t.  An m16n8
// accumulator c holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]), columns
// 2t and 2t + 1.
//
// smem: Qs [BQ][LD] | Ks [2][BK][LD] | Vs [2][BK][LD], LD = D + PAD, bf16.
template <int D, int BK>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_fwd_mma_kernel(const Params p) {
  constexpr int LD = D + PAD;
  constexpr int CH = D / 8;   // 16-byte chunks in a row
  constexpr int NT = BK / 8;  // score n-tiles of a warp
  constexpr int DT = D / 8;   // output n-tiles of a warp
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + 2 * BK * LD;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // late causal tiles carry more work
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // rows [row0, row0 + ROWS) of a (S, D) operand into dst; rows at or past
  // `limit` are zero-filled.
  auto load_tile = [&](bf16* dst, const bf16* src, long long stride, int row0, int rows,
                       int limit) {
    for (int idx = tid; idx < rows * CH; idx += MMA_THREADS) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const bool ok = row0 + r < limit;
      cp_async16(dst + r * LD + c, ok ? src + (long long)(row0 + r) * stride + c : src, ok);
    }
  };

  int kt_begin, kt_end;
  kv_range(p, q0, BK, kt_begin, kt_end);

  load_tile(Qs, qb, p.q_ss, q0, BQ, p.Sq);
  if (kt_begin < kt_end) {
    load_tile(Ks, kb, p.k_ss, kt_begin * BK, BK, p.Sk);
    load_tile(Vs, vb, p.v_ss, kt_begin * BK, BK, p.Sk);
  }
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of rows g and g + 8 (log2 units)
  float l[2] = {0.f, 0.f};          // this lane's part of the running sums

  const int row_a = q0 + warp * 16 + g;  // this lane's rows: row_a, row_a + 8
  const float qk_scale = p.scale * LOG2E;
  const bf16* q_frag = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int k_frag = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int v_frag = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // the next tile goes into the other buffer
      load_tile(Ks + (buf ^ 1) * BK * LD, kb, p.k_ss, (kt + 1) * BK, BK, p.Sk);
      load_tile(Vs + (buf ^ 1) * BK * LD, vb, p.v_ss, (kt + 1) * BK, BK, p.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and Q) have landed for every thread
    const bf16* Kt = Ks + buf * BK * LD;
    const bf16* Vt = Vs + buf * BK * LD;

    // S = Q K^T for this warp's 16 rows, BK columns.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_frag + kk * 16);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + jp * 16 * LD + k_frag + kk * 16);
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // scale and softcap in fp32, in log2 units; then the mask, only in tiles
    // where it can bite.  Both branches are uniform over the block.
    if (p.softcap > 0.f) {
      const float in = p.scale / p.softcap, out = p.softcap * LOG2E;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = out * tanhf(s[j][e] * in);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= qk_scale;
    }
    const int k0 = kt * BK;
    if (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0) ||
        (p.window > 0 && k0 <= q0 + BQ - 1 - p.window)) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qp = row_a + (e >> 1) * 8;
          bool ok = kp < p.Sk;
          if (p.causal) ok = ok && kp <= qp;
          if (p.window > 0) ok = ok && kp > qp - p.window;
          if (!ok) s[j][e] = NEG_INF;
        }
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // O += P V, P in bf16 straight from the score accumulators.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + kk * 16 * LD + v_frag + jp * 16);
        mma_bf16(o[2 * jp], a, bv[0], bv[1]);
        mma_bf16(o[2 * jp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block, even with no kv tile to see

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_a + r * 8;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    if (p.lse != nullptr && t == 0)  // m and l are in log2 units
      p.lse[((long long)b * p.Hq + h) * p.Sq + row] = (m[r] + log2f(fmaxf(l[r], 1e-30f))) * LN2;
    bf16* orow = ob + (long long)row * p.o_ss + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr int BK = D >= 256 ? 32 : 64;  // leaves registers for the 128-float accumulator
  const size_t smem = (size_t)(BQ + 4 * BK) * (D + PAD) * sizeof(bf16);
  auto kern = flash_fwd_mma_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  kern<<<grid, MMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int dtype, int B, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(p, B, stream);
  if (dtype == 1) return launch_bf16<D>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements; the last dim of
// every tensor is contiguous.  window <= 0 means none; softcap <= 0 means
// none; lse may be null.  Returns the cudaError_t of the launch (0 on
// success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        float scale, int causal, int window, float softcap,
                        void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  Params p{q, k, v, o, lse, Hq, Hkv, Sq, Sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           scale, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, dtype, B, s);
    case 32: return launch<32>(p, dtype, B, s);
    case 64: return launch<64>(p, dtype, B, s);
    case 128: return launch<128>(p, dtype, B, s);
    case 256: return launch<256>(p, dtype, B, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
