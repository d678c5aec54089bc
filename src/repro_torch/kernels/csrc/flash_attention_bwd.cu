// Backward flash attention for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// The JAX package has no backward Pallas kernel (its gradients go through
// XLA's `sdpa_chunked`, src/repro/models/attention.py:46); this is the
// backward of the port's forward kernel (flash_attention.cu), which replaces
// `_flash_kernel` / `flash_attention` of src/repro/kernels/flash_attention.py.
// It takes the forward's whole contract: causal or full attention, a sliding
// window, a logit softcap, GQA/MQA, ragged Sq and Sk, f32 or bf16 inputs,
// head_dim 16/32/64/128/256.
//
// Inputs q, k, v, the forward's output o, its gradient dO and the row
// log-sum-exp (LSE) that the forward wrote; outputs dQ, dK, dV in the
// inputs' dtype.  All arithmetic is fp32.  With z = scale q.k,
// s = softcap tanh(z / softcap) (or z), P = exp(s - LSE) on the unmasked
// (q, k) pairs and 0 elsewhere, Delta = rowsum(dO o):
//   dV = P^T dO,  dS = P (dO V^T - Delta) (1 - tanh^2(z / softcap)) scale,
//   dQ = dS K,    dK = dS^T Q,
// dK and dV summed over the q heads of a kv group.
//
// What bounds it on the H100: like the forward it does hundreds of
// operations per byte at the training shapes (five products per (q, k)
// pair against the forward's two), so arithmetic, and the arithmetic
// belongs on the tensor cores.  Two paths share one contract, as in the
// forward:
//
// bf16 (`flash_bwd_dq_mma_kernel`, `flash_bwd_dkdv_mma_kernel`): the
// FlashAttention-2 backward on `mma.sync.m16n8k16` (bf16 in, fp32 out), with
// the forward's fragment patterns (`ldmatrix`, padded shared rows,
// double-buffered `cp.async`).
//   * dQ: one block of 4 warps per (b, h, 64-row q tile), each warp 16 q
//     rows.  It first forms Delta for its rows (and writes it for the dK/dV
//     pass), then walks the kv tiles that the q tile can see: S = Q K^T and
//     dP = dO V^T from shared memory, P = exp(S - LSE) and dS in registers,
//     and dQ += dS K with dS rounded to bf16 as the A operand straight from
//     the accumulators.
//   * dK, dV: one block of 4 warps per (b, q head, 64-row key tile), each
//     warp 16 key rows; it walks the q tiles that can see the key tile:
//     S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.  A block
//     per q head (not per kv head) keeps gemma-2b's MQA (8 q heads on one kv
//     head) at 512 blocks; each head's fp32 part is summed over its group in
//     head order by `group_sum_kernel` (deterministic, no atomics).  At
//     D = 256 the dK and dV accumulators (128 floats a thread each) do not
//     fit one thread together, so they are two launches of the kernel.
//   P and dS are rounded to bf16 before their products, as the forward
//   rounds P; that is the rounding the fp32 plain version does not make.
//
// f32 (`flash_bwd_dq_kernel`, `flash_bwd_dkdv_kernel`): the only
// tensor-core path for fp32 is TF32, which would break the fp32 tolerance,
// so fp32 stays on the CUDA cores: 16 x 16 threads, a thread owns RM rows
// and every 16th column of a tile; operands sit transposed in shared memory
// ([d][row]), a tile read both ways padded to an odd row length so neither
// read conflicts.  The dK/dV block there owns a kv head and walks the q
// heads of its group itself.
//
// Both are deterministic and use no atomics.  Left for later (ROADMAP B.1):
// `wgmma`, TMA loads and a deeper ring, as for the forward.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;  // 16 x 16

struct Params {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;  // (B, Hq, Sq)
  float* delta;      // (B, Hq, Sq), written by the dQ kernel
  void* dq; void* dk; void* dv;
  int Hq, Hkv, Sq, Sk;
  // (batch, head, seq) strides in elements: q, k, v, o, dO, dQ, dK, dV
  long long st[8][3];
  float scale; int causal; int window; float softcap;
};
enum { Q, K, V, O, DO, DQ, DK, DV };

template <typename T>
__device__ __forceinline__ const T* at(const Params& p, int which, int b, int h) {
  return static_cast<const T*>(which == Q ? p.q : which == K ? p.k : which == V ? p.v
                               : which == O ? p.o : p.dout)
         + b * p.st[which][0] + h * p.st[which][1];
}

// Rows [row0, row0 + rows) of a (S, D) fp32 operand, transposed into
// dst[d * ld + r]; rows at or past `limit` read as zero.
template <int D>
__device__ __forceinline__ void load_t(float* dst, int ld, const float* src, long long stride,
                                       int row0, int rows, int limit) {
  for (int idx = threadIdx.x; idx < rows * (D / 4); idx += THREADS) {
    const int r = idx % rows, d0 = (idx / rows) * 4;
    const float4 x = row0 + r < limit
        ? *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * stride + d0)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[d0 * ld + r] = x.x;
    dst[(d0 + 1) * ld + r] = x.y;
    dst[(d0 + 2) * ld + r] = x.z;
    dst[(d0 + 3) * ld + r] = x.w;
  }
}

template <int RM>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[RM]) {
  if constexpr (RM == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (RM == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i) x[i] = p[i];
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp) {
  bool ok = qp < p.Sq && kp < p.Sk;
  if (p.causal) ok = ok && kp <= qp;
  if (p.window > 0) ok = ok && kp > qp - p.window;
  return ok;
}

// P and dS of one (q, k) pair from its raw product q.k and dO.v.
__device__ __forceinline__ void p_ds(const Params& p, bool ok, float qk, float dov, float lse,
                                     float delta, float& pr, float& ds) {
  float z = qk * p.scale, deriv = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(z / p.softcap);
    z = p.softcap * t;
    deriv = 1.f - t * t;
  }
  pr = ok ? expf(z - lse) : 0.f;
  ds = pr * (dov - delta) * deriv * p.scale;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores.  dQ (and Delta): one block per (b, h, q tile of
// BQ = 16 RM rows)
// ---------------------------------------------------------------------------

// smem: QsT [D][BQ] | dOsT [D][BQ] | KsT [D][BK+1] | VsT [D][BK+1] |
//       DSs [BK][BQ+4] (dS^T) | lse_s [BQ] | delta_s [BQ]
template <int D, int RM, int BK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const Params p) {
  constexpr int BQ = 16 * RM;
  constexpr int CN = BK / 16;  // score columns per thread
  constexpr int DN = D / 16;   // dQ columns per thread
  constexpr int LK = BK + 1;
  constexpr int LS = BQ + 4;
  extern __shared__ float4 smem4[];
  float* QsT = reinterpret_cast<float*>(smem4);
  float* dOsT = QsT + D * BQ;
  float* KsT = dOsT + D * BQ;
  float* VsT = KsT + D * LK;
  float* DSs = VsT + D * LK;
  float* lse_s = DSs + BK * LS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // late causal tiles carry more work
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;

  const float* qb = at<float>(p, Q, b, h);
  const float* ob = at<float>(p, O, b, h);
  const float* dob = at<float>(p, DO, b, h);
  const float* kb = at<float>(p, K, b, kvh);
  const float* vb = at<float>(p, V, b, kvh);

  // Delta = rowsum(dO o), one warp per row; written for the dK/dV kernel.
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < p.Sq) {
      for (int d = lane; d < D; d += 32)
        acc += dob[(long long)row * p.st[DO][2] + d] * ob[(long long)row * p.st[O][2] + d];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = row < p.Sq ? p.lse[row_base + row] : 0.f;
      if (row < p.Sq) p.delta[row_base + row] = acc;
    }
  }
  load_t<D>(QsT, BQ, qb, p.st[Q][2], q0, BQ, p.Sq);
  load_t<D>(dOsT, BQ, dob, p.st[DO][2], q0, BQ, p.Sq);

  // the kv tiles the q tile can see (the forward's loop bounds)
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kt_end = (p.Sk + BK - 1) / BK;
  if (p.causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) kt_begin = (q0 - p.window + 1) / BK;

  float dq[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) dq[i][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is done with KsT, VsT and DSs
    load_t<D>(KsT, LK, kb, p.st[K][2], k0, BK, p.Sk);
    load_t<D>(VsT, LK, vb, p.st[V][2], k0, BK, p.Sk);
    __syncthreads();

    // q.k and dO.v: rows ty*RM + i, columns tx + 16 j
    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[RM], dr[RM];
      load_rows<RM>(&QsT[d * BQ + ty * RM], qr);
      load_rows<RM>(&dOsT[d * BQ + ty * RM], dr);
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float kv = KsT[d * LK + tx + 16 * j];
        const float vv = VsT[d * LK + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          s[i][j] = fmaf(qr[i], kv, s[i][j]);
          dp[i][j] = fmaf(dr[i], vv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 16 * j;
        float pr, ds;
        p_ds(p, visible(p, q0 + r, k0 + c), s[i][j], dp[i][j], lse_s[r], delta_s[r], pr, ds);
        DSs[c * LS + r] = ds;
      }
    }
    __syncthreads();

    // dQ += dS K, K read from its transposed tile
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsr[RM];
      load_rows<RM>(&DSs[j * LS + ty * RM], dsr);
#pragma unroll
      for (int c = 0; c < DN; ++c) {
        const float kv = KsT[(tx + 16 * c) * LK + j];
#pragma unroll
        for (int i = 0; i < RM; ++i) dq[i][c] = fmaf(dsr[i], kv, dq[i][c]);
      }
    }
  }

  float* dqb = static_cast<float*>(p.dq) + b * p.st[DQ][0] + h * p.st[DQ][1];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < DN; ++c) dqb[(long long)row * p.st[DQ][2] + tx + 16 * c] = dq[i][c];
  }
}

// ---------------------------------------------------------------------------
// f32: dK, dV: one block per (b, kv head, key tile of BKV = 16 RM rows)
// ---------------------------------------------------------------------------

// smem: KsT [D][BKV] | VsT [D][BKV] | QsT [D][BQC+1] | dOsT [D][BQC+1] |
//       PsT [BQC][BKV+4] | DSsT [BQC][BKV+4] | lse_s [BQC] | delta_s [BQC]
template <int D, int RM, int BQC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const Params p) {
  constexpr int BKV = 16 * RM;
  constexpr int CN = BQC / 16;  // q columns per thread
  constexpr int DN = D / 16;    // dK/dV columns per thread
  constexpr int LQ = BQC + 1;
  constexpr int LS = BKV + 4;
  extern __shared__ float4 smem4[];
  float* KsT = reinterpret_cast<float*>(smem4);
  float* VsT = KsT + D * BKV;
  float* QsT = VsT + D * BKV;
  float* dOsT = QsT + D * LQ;
  float* PsT = dOsT + D * LQ;
  float* DSsT = PsT + BQC * LS;
  float* lse_s = DSsT + BQC * LS;
  float* delta_s = lse_s + BQC;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kt = blockIdx.x;  // early causal key tiles carry more work
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int k0 = kt * BKV;

  load_t<D>(KsT, BKV, at<float>(p, K, b, kvh), p.st[K][2], k0, BKV, p.Sk);
  load_t<D>(VsT, BKV, at<float>(p, V, b, kvh), p.st[V][2], k0, BKV, p.Sk);

  // the q tiles that can see the key tile
  const int k_last = min(k0 + BKV, p.Sk) - 1;
  int q_end = p.Sq;
  if (p.window > 0) q_end = min(q_end, k_last + p.window);
  const int qt_begin = p.causal ? k0 / BQC : 0;
  const int qt_end = (q_end + BQC - 1) / BQC;

  float dk[RM][DN], dv[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DN; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int hg = 0; hg < group; ++hg) {
    const int h = kvh * group + hg;
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    const float* qb = at<float>(p, Q, b, h);
    const float* dob = at<float>(p, DO, b, h);
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQC;
      __syncthreads();  // the previous tile is done with QsT, dOsT, PsT and DSsT
      load_t<D>(QsT, LQ, qb, p.st[Q][2], q0, BQC, p.Sq);
      load_t<D>(dOsT, LQ, dob, p.st[DO][2], q0, BQC, p.Sq);
      for (int r = tid; r < BQC; r += THREADS) {
        const bool in = q0 + r < p.Sq;
        lse_s[r] = in ? p.lse[row_base + q0 + r] : 0.f;
        delta_s[r] = in ? p.delta[row_base + q0 + r] : 0.f;
      }
      __syncthreads();

      // k.q and v.dO: key rows ty*RM + i, q columns tx + 16 j
      float s[RM][CN], dp[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kr[RM], vr[RM];
        load_rows<RM>(&KsT[d * BKV + ty * RM], kr);
        load_rows<RM>(&VsT[d * BKV + ty * RM], vr);
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const float qv = QsT[d * LQ + tx + 16 * j];
          const float dov = dOsT[d * LQ + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            s[i][j] = fmaf(kr[i], qv, s[i][j]);
            dp[i][j] = fmaf(vr[i], dov, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty * RM + i;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int c = tx + 16 * j;
          float pr, ds;
          p_ds(p, visible(p, q0 + c, k0 + r), s[i][j], dp[i][j], lse_s[c], delta_s[c], pr, ds);
          PsT[c * LS + r] = pr;
          DSsT[c * LS + r] = ds;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q, dO and Q read from their transposed tiles
#pragma unroll 2
      for (int j = 0; j < BQC; ++j) {
        float pr[RM], dsr[RM];
        load_rows<RM>(&PsT[j * LS + ty * RM], pr);
        load_rows<RM>(&DSsT[j * LS + ty * RM], dsr);
#pragma unroll
        for (int c = 0; c < DN; ++c) {
          const float dov = dOsT[(tx + 16 * c) * LQ + j];
          const float qv = QsT[(tx + 16 * c) * LQ + j];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            dv[i][c] = fmaf(pr[i], dov, dv[i][c]);
            dk[i][c] = fmaf(dsr[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  float* dkb = static_cast<float*>(p.dk) + b * p.st[DK][0] + kvh * p.st[DK][1];
  float* dvb = static_cast<float*>(p.dv) + b * p.st[DV][0] + kvh * p.st[DV][1];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = k0 + ty * RM + i;
    if (row >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < DN; ++c) {
      dkb[(long long)row * p.st[DK][2] + tx + 16 * c] = dk[i][c];
      dvb[(long long)row * p.st[DV][2] + tx + 16 * c] = dv[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16), the fragment patterns of the
// forward's flash_fwd_mma_kernel
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows
constexpr int MMA_ROWS = 64;      // q rows of a dQ block, key rows of a dK/dV block
constexpr int PAD = 8;            // bf16 elements (16 bytes) of padding per shared row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

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

// Rows [row0, row0 + rows) of a (S, D) bf16 operand into dst [rows][D + PAD]
// with 16-byte cp.async; rows at or past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, long long stride, int row0,
                                        int rows, int limit) {
  constexpr int CH = D / 8, LD = D + PAD;
  for (int idx = threadIdx.x; idx < rows * CH; idx += MMA_THREADS) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * LD + c, ok ? src + (long long)(row0 + r) * stride + c : src, ok);
  }
}

// Fragment offsets of a lane (PTX ISA, mma.m16n8k16; lane = 4 g + t; an
// m16n8 accumulator holds rows g and g + 8, columns 2t and 2t + 1):
//   A from a row-major [m][k] tile:                 + m0 * LD + k0
//   B (two n-tiles) from a row-major [n][k] tile:   + n0 * LD + k0
//   B (two n-tiles) from a row-major [k][n] tile, ldmatrix.trans: + k0 * LD + n0
template <int LD> __device__ __forceinline__ int a_off(int lane) {
  return (lane & 15) * LD + (lane >> 4) * 8;
}
template <int LD> __device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
}
template <int LD> __device__ __forceinline__ int bt_off(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;
}

// c[NT][4] += A (16 x D, from a) . B^T (NT*8 rows of a [n][D] tile, from b)
template <int D, int NT>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const bf16* a, const bf16* b) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + kk * 16);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + jp * 16 * LD + kk * 16);
      mma_bf16(c[2 * jp], af, bf[0], bf[1]);
      mma_bf16(c[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D/8][4] += X (16 x 8 NT, fp32 accumulators rounded to bf16) . Y (8 NT
// rows of a [k][D] tile, from y)
template <int D, int NT>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4], const float (&x)[NT][4],
                                        const bf16* y) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t af[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, y + kk * 16 * LD + jp * 16);
      mma_bf16(acc[2 * jp], af, bf[0], bf[1]);
      mma_bf16(acc[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// P (log2 units against lse2) and dS of one pair from q.k and dO.v.
__device__ __forceinline__ void p_ds2(const Params& p, bool ok, float qk, float dov, float lse2,
                                      float delta, float& pr, float& ds) {
  float z = qk * p.scale, deriv = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(z / p.softcap);
    z = p.softcap * t;
    deriv = 1.f - t * t;
  }
  pr = ok ? exp2f(fmaf(z, LOG2E, -lse2)) : 0.f;
  ds = pr * (dov - delta) * deriv * p.scale;
}

// dQ (and Delta): one block of 4 warps per (b, h, 64-row q tile); each warp
// owns 16 q rows.  K and V tiles of BK rows are double-buffered.
// smem: Qs [64][LD] | dOs [64][LD] | Ks [2][BK][LD] | Vs [2][BK][LD] | delta_s [64] f32
template <int D, int BK>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_bwd_dq_mma_kernel(const Params p) {
  constexpr int BQ = MMA_ROWS, LD = D + PAD, NT = BK / 8, DT = D / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + 2 * BK * LD;
  float* delta_s = reinterpret_cast<float*>(Vs + 2 * BK * LD);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // late causal tiles carry more work
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
  const bf16* qb = at<bf16>(p, Q, b, h);
  const bf16* ob = at<bf16>(p, O, b, h);
  const bf16* dob = at<bf16>(p, DO, b, h);
  const bf16* kb = at<bf16>(p, K, b, kvh);
  const bf16* vb = at<bf16>(p, V, b, kvh);

  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kt_end = (p.Sk + BK - 1) / BK;
  if (p.causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) kt_begin = (q0 - p.window + 1) / BK;

  cp_tile<D>(Qs, qb, p.st[Q][2], q0, BQ, p.Sq);
  cp_tile<D>(dOs, dob, p.st[DO][2], q0, BQ, p.Sq);
  if (kt_begin < kt_end) {
    cp_tile<D>(Ks, kb, p.st[K][2], kt_begin * BK, BK, p.Sk);
    cp_tile<D>(Vs, vb, p.st[V][2], kt_begin * BK, BK, p.Sk);
  }
  cp_async_commit();

  // Delta = rowsum(dO o) while the copies fly, one warp per row; written
  // for the dK/dV kernel.
  for (int r = warp; r < BQ; r += MMA_THREADS / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < p.Sq) {
      for (int d = lane; d < D; d += 32)
        acc += __bfloat162float(dob[(long long)row * p.st[DO][2] + d]) *
               __bfloat162float(ob[(long long)row * p.st[O][2] + d]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[r] = acc;
      if (row < p.Sq) p.delta[row_base + row] = acc;
    }
  }
  __syncthreads();
  const int row_a = q0 + warp * 16 + g;  // this lane's rows: row_a, row_a + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < p.Sq ? p.lse[row_base + row] * LOG2E : 0.f;
    dlt[r] = delta_s[warp * 16 + g + 8 * r];
  }

  float dq[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const bf16* q_a = Qs + warp * 16 * LD + a_off<LD>(lane);
  const bf16* do_a = dOs + warp * 16 * LD + a_off<LD>(lane);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {  // the next tile goes into the other buffer
      cp_tile<D>(Ks + (buf ^ 1) * BK * LD, kb, p.st[K][2], (kt + 1) * BK, BK, p.Sk);
      cp_tile<D>(Vs + (buf ^ 1) * BK * LD, vb, p.st[V][2], (kt + 1) * BK, BK, p.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and Q, dO) have landed for every thread
    const bf16* Kt = Ks + buf * BK * LD;
    const bf16* Vt = Vs + buf * BK * LD;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows<D, NT>(s, q_a, Kt + b_off<LD>(lane));
    mma_rows<D, NT>(dp, do_a, Vt + b_off<LD>(lane));

    const int k0 = kt * BK;
    const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0) ||
                      (p.window > 0 && k0 <= q0 + BQ - 1 - p.window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = !edge || visible(p, row_a + 8 * r, k0 + 8 * j + 2 * t + (e & 1));
        float pr;
        p_ds2(p, ok, s[j][e], dp[j][e], lse2[r], dlt[r], pr, s[j][e]);  // s := dS
      }
    }
    mma_acc<D, NT>(dq, s, Kt + bt_off<LD>(lane));  // dQ += dS K
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block, even with no kv tile to see

  bf16* dqb = static_cast<bf16*>(p.dq) + b * p.st[DQ][0] + h * p.st[DQ][1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= p.Sq) continue;
    bf16* orow = dqb + (long long)row * p.st[DQ][2] + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(dq[j][2 * r], dq[j][2 * r + 1]);
  }
}

// dK and/or dV of one q head: one block of 4 warps per (b, q head, 64-row
// key tile); each warp owns 16 key rows and walks the q tiles (BQC rows,
// double-buffered) that can see the key tile.  With one q head per kv head
// the block writes dK/dV in bf16; otherwise its fp32 part (B, Hq, Sk, D),
// which group_sum_kernel sums over the group.  At D = 256 the dK and dV
// accumulators do not fit one thread's registers together, so the two are
// separate launches.
// smem: Ks [64][LD] | Vs [64][LD] | Qs [2][BQC][LD] | dOs [2][BQC][LD] |
//       lse_s [2][BQC] (log2 units) | delta_s [2][BQC]
template <int D, int BQC, bool WITH_DK, bool WITH_DV>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_bwd_dkdv_mma_kernel(const Params p, float* dk_part, float* dv_part) {
  constexpr int BKV = MMA_ROWS, LD = D + PAD, NT = BQC / 8, DT = D / 8;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;
  bf16* dOs = Qs + 2 * BQC * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQC * LD);
  float* delta_s = lse_s + 2 * BQC;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int kt = blockIdx.x;  // early causal key tiles carry more work
  const int h = blockIdx.y, b = blockIdx.z;
  const int group = p.Hq / p.Hkv, kvh = h / group;
  const int k0 = kt * BKV;
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
  const bf16* qb = at<bf16>(p, Q, b, h);
  const bf16* dob = at<bf16>(p, DO, b, h);

  const int k_last = min(k0 + BKV, p.Sk) - 1;
  int q_end = p.Sq;
  if (p.window > 0) q_end = min(q_end, k_last + p.window);
  const int qt_begin = p.causal ? k0 / BQC : 0;
  const int qt_end = (q_end + BQC - 1) / BQC;

  // the q tile qt into buffer buf: Q and dO by cp.async, LSE and Delta by
  // plain stores (both read after the next barrier)
  auto stage = [&](int qt, int buf) {
    cp_tile<D>(Qs + buf * BQC * LD, qb, p.st[Q][2], qt * BQC, BQC, p.Sq);
    cp_tile<D>(dOs + buf * BQC * LD, dob, p.st[DO][2], qt * BQC, BQC, p.Sq);
    for (int r = tid; r < BQC; r += MMA_THREADS) {
      const int row = qt * BQC + r;
      lse_s[buf * BQC + r] = row < p.Sq ? p.lse[row_base + row] * LOG2E : 0.f;
      delta_s[buf * BQC + r] = row < p.Sq ? p.delta[row_base + row] : 0.f;
    }
  };

  cp_tile<D>(Ks, at<bf16>(p, K, b, kvh), p.st[K][2], k0, BKV, p.Sk);
  cp_tile<D>(Vs, at<bf16>(p, V, b, kvh), p.st[V][2], k0, BKV, p.Sk);
  if (qt_begin < qt_end) stage(qt_begin, 0);
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const bf16* k_a = Ks + warp * 16 * LD + a_off<LD>(lane);
  const bf16* v_a = Vs + warp * 16 * LD + a_off<LD>(lane);
  const int key_a = k0 + warp * 16 + g;  // this lane's key rows: key_a, key_a + 8

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int buf = (qt - qt_begin) & 1;
    if (qt + 1 < qt_end) {
      stage(qt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + buf * BQC * LD;
    const bf16* dOt = dOs + buf * BQC * LD;
    const float* lse_t = lse_s + buf * BQC;
    const float* dl_t = delta_s + buf * BQC;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys, columns q
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows<D, NT>(s, k_a, Qt + b_off<LD>(lane));
    if constexpr (WITH_DK) mma_rows<D, NT>(dp, v_a, dOt + b_off<LD>(lane));

    const int q0 = qt * BQC;
    const bool edge = q0 + BQC > p.Sq || k0 + BKV > p.Sk || (p.causal && q0 < k0 + BKV - 1) ||
                      (p.window > 0 && q0 + BQC - 1 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const bool ok = !edge || visible(p, q0 + c, key_a + 8 * (e >> 1));
        p_ds2(p, ok, s[j][e], dp[j][e], lse_t[c], dl_t[c], s[j][e], dp[j][e]);  // P^T, dS^T
      }
    }
    if constexpr (WITH_DV) mma_acc<D, NT>(dv, s, dOt + bt_off<LD>(lane));  // dV += P^T dO
    if constexpr (WITH_DK) mma_acc<D, NT>(dk, dp, Qt + bt_off<LD>(lane));  // dK += dS^T Q
    __syncthreads();
  }
  cp_async_wait<0>();

  // rows key_a and key_a + 8 of one accumulator: bf16 into dK/dV, or the
  // head's fp32 part
  auto store = [&](const float (&acc)[DT][4], int which, void* out, float* part) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = key_a + 8 * r;
      if (row >= p.Sk) continue;
      if (group == 1) {
        bf16* orow = static_cast<bf16*>(out) + b * p.st[which][0] + kvh * p.st[which][1] +
                     (long long)row * p.st[which][2] + 2 * t;
#pragma unroll
        for (int j = 0; j < DT; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
      } else {
        float* orow = part + (((long long)b * p.Hq + h) * p.Sk + row) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < DT; ++j)
          *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  };
  if constexpr (WITH_DK) store(dk, DK, p.dk, dk_part);
  if constexpr (WITH_DV) store(dv, DV, p.dv, dv_part);
}

// dK or dV (B, Hkv, Sk, D) bf16 = the sum of the fp32 parts (B, Hq, Sk, D)
// over the q heads of each kv group, in head order.
__global__ void group_sum_kernel(const float* part, bf16* out, long long sb, long long sh,
                                 long long ss, int B, int Hq, int Hkv, int Sk, int D) {
  const long long n = (long long)B * Hkv * Sk * D;
  const int group = Hq / Hkv;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int d = i % D;
    const int s = (i / D) % Sk;
    const int kvh = (i / ((long long)D * Sk)) % Hkv;
    const int b = i / ((long long)D * Sk * Hkv);
    float acc = 0.f;
    for (int hg = 0; hg < group; ++hg)
      acc += part[(((long long)b * Hq + kvh * group + hg) * Sk + s) * D + d];
    out[b * sb + kvh * sh + s * ss + d] = __float2bfloat16(acc);
  }
}

template <int D, int BQC, bool WITH_DK, bool WITH_DV>
cudaError_t launch_dkdv_mma(const Params& p, int B, float* dk_part, float* dv_part,
                            cudaStream_t stream) {
  constexpr int LD = D + PAD;
  const size_t smem = (size_t)(2 * MMA_ROWS + 4 * BQC) * LD * sizeof(bf16) + 4 * BQC * sizeof(float);
  auto kern = flash_bwd_dkdv_mma_kernel<D, BQC, WITH_DK, WITH_DV>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((p.Sk + MMA_ROWS - 1) / MMA_ROWS, p.Hq, B), MMA_THREADS, smem, stream>>>(
      p, dk_part, dv_part);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, float* dk_part, float* dv_part,
                        cudaStream_t stream) {
  // tiles that leave registers for the D-wide fp32 accumulators
  constexpr int BK = D >= 256 ? 16 : D >= 128 ? 32 : 64;
  constexpr int LD = D + PAD;
  const size_t dq_smem = (size_t)(2 * MMA_ROWS + 4 * BK) * LD * sizeof(bf16) +
                         MMA_ROWS * sizeof(float);
  auto dq_kern = flash_bwd_dq_mma_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  dq_kern<<<dim3((p.Sq + MMA_ROWS - 1) / MMA_ROWS, p.Hq, B), MMA_THREADS, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if constexpr (D >= 256) {
    err = launch_dkdv_mma<D, BK, true, false>(p, B, dk_part, dv_part, stream);
    if (err != cudaSuccess) return err;
    err = launch_dkdv_mma<D, BK, false, true>(p, B, dk_part, dv_part, stream);
  } else {
    err = launch_dkdv_mma<D, BK, true, true>(p, B, dk_part, dv_part, stream);
  }
  if (err != cudaSuccess || p.Hq == p.Hkv) return err;
  const int threads = 256, blocks = 132 * 8;
  group_sum_kernel<<<blocks, threads, 0, stream>>>(dk_part, static_cast<bf16*>(p.dk),
      p.st[DK][0], p.st[DK][1], p.st[DK][2], B, p.Hq, p.Hkv, p.Sk, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_sum_kernel<<<blocks, threads, 0, stream>>>(dv_part, static_cast<bf16*>(p.dv),
      p.st[DV][0], p.st[DV][1], p.st[DV][2], B, p.Hq, p.Hkv, p.Sk, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  // 32-row tiles at D = 256 keep the fp32 operands of a block in shared memory
  constexpr int RM = D >= 256 ? 2 : 4;
  constexpr int BQ = 16 * RM, BK = 16 * RM, BKV = 16 * RM, BQC = 16 * RM;

  auto dq_kern = flash_bwd_dq_kernel<D, RM, BK>;
  const size_t dq_smem =
      (size_t)(2 * D * BQ + 2 * D * (BK + 1) + BK * (BQ + 4) + 2 * BQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  dq_kern<<<dim3((p.Sq + BQ - 1) / BQ, p.Hq, B), THREADS, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kv_kern = flash_bwd_dkdv_kernel<D, RM, BQC>;
  const size_t kv_smem =
      (size_t)(2 * D * BKV + 2 * D * (BQC + 1) + 2 * BQC * (BKV + 4) + 2 * BQC) * sizeof(float);
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return err;
  kv_kern<<<dim3((p.Sk + BKV - 1) / BKV, p.Hkv, B), THREADS, kv_smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, int dtype, int B, float* dk_part, float* dv_part,
                     cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(p, B, stream);
  if (dtype == 1) return launch_bf16<D>(p, B, dk_part, dv_part, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 24 values, the (batch, head,
// seq) strides in elements of q, k, v, o, dO, dQ, dK, dV, whose last dim is
// contiguous.  lse is the forward's (B, Hq, Sq) fp32 output; delta is fp32
// scratch of the same shape; dk_part and dv_part are fp32 scratch of
// (B, Hq, Sk, D), needed for bf16 with Hq > Hkv (else they may be null).
// window <= 0 means none; softcap <= 0 means none.  Launches the dQ kernel,
// then the dK/dV kernel(s) (and for bf16 GQA the group sums); returns the
// first cudaError_t (0 on success).
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta,
                        void* dq, void* dk, void* dv, float* dk_part, float* dv_part,
                        int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                        const long long* strides,
                        float scale, int causal, int window, float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, lse, delta, dq, dk, dv, Hq, Hkv, Sq, Sk, {}, scale, causal, window,
           softcap};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.st[t][i] = strides[3 * t + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(p, dtype, B, dk_part, dv_part, s);
    case 32: return launch_d<32>(p, dtype, B, dk_part, dv_part, s);
    case 64: return launch_d<64>(p, dtype, B, dk_part, dv_part, s);
    case 128: return launch_d<128>(p, dtype, B, dk_part, dv_part, s);
    case 256: return launch_d<256>(p, dtype, B, dk_part, dv_part, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
