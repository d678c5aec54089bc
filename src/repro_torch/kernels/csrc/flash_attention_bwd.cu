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
// What bounds it on the H100: five products per (q, k) pair (Q K^T, dO V^T,
// P^T dO, dS K, dS^T Q), hundreds of operations per byte: 42.99 GFLOP at
// gemma-2b's training shape (B=4, Hq=8, Hkv=1, S=1024, D=256, causal), 0.0435
// ms on the bf16 tensor cores at 989 TFLOP/s.  So arithmetic, and the
// arithmetic belongs on the tensor cores.  Two paths share one contract, as
// in the forward:
//
// bf16 (`flash_bwd_dq_mma_kernel`, `flash_bwd_dkdv_mma_kernel`,
// `group_sum_kernel`): FlashAttention-2's backward tiling on
// `mma.sync.m16n8k16` (bf16 in, fp32 out): 64 x 64 tiles, blocks of 8 warps
// (two warpgroups), one block per SM, double-buffered `cp.async`, `ldmatrix`
// from shared rows padded by 16 bytes.  Every shape of the contract is one
// template; the warps of a block split the work in two phases:
//   phase 1, 64 x 64 scores over the full D: 4 x 2 warps, each 16 rows x 32
//     columns of both products (S and dP, or S^T and dP^T), so each thread
//     holds P and dP of the same pairs and forms dS from the fp32 P;
//   phase 2, the accumulators, 64 rows x D: warpgroup 0 owns columns
//     [0, D/2), warpgroup 1 [D/2, D); at D >= 64 each warp 32 rows x D/4.
//   * dQ (and Delta): one block per (b, q head, 64-row q tile).  It forms
//     Delta first and writes it for the dK/dV kernel, then walks the 64-key
//     tiles the q tile can see (K and V double-buffered): S = Q K^T and
//     dP = dO V^T, P and dS in registers, dS to shared memory in bf16, then
//     dQ += dS K.  A warp's Q fragments are the same in every key tile, so
//     they stay in registers for the whole walk.
//   * dK, dV: one block per (b, q head, 64-key tile), walking the 64-row q
//     tiles that can see it (Q, dO, LSE and Delta double-buffered):
//     S^T = K Q^T and dP^T = V dO^T, P^T and dS^T to shared memory in bf16,
//     then dV += P^T dO and dK += dS^T Q.  At D = 256 that is 64 + 64 fp32
//     accumulators a thread, so both come from one pass: four products per
//     pair here and three in the dQ kernel (the design this replaced, with
//     16-row tiles on 4 warps, ran the dK/dV kernel twice at D = 256 and
//     formed S^T in both).  The two warpgroups do not split S^T from dP^T:
//     dS^T needs P^T and, under a softcap, the derivative at the same pair,
//     and passing those in fp32 through shared memory would take 16 KB more
//     than the 227 KB a block has.
//   * MQA/GQA: a block per q head, not per kv head (gemma-2b's one kv head
//     would give 64 blocks for 132 SMs), so each q head's dK and dV are
//     written as fp32 parts (B, Hq, Sk, D) and one `group_sum_kernel` adds
//     both over each group in head order (deterministic, no atomics).
//   Under causal attention the early key tiles and the late q tiles carry
//   the most work; the tile index is the grid's slowest axis, so they are
//   dispatched first.  P and dS are rounded to bf16 before their products,
//   as the forward rounds P; that is the rounding the fp32 plain version does
//   not make (`ref.mha_backward_tiled` mirrors it on the CPU).
//   Per block at D = 256 (`nvcc -Xptxas -v`, printed by chip_smoke.py's
//   build phase): dQ 238 registers and 212,224 bytes of shared memory,
//   dK/dV 240 registers and 222,208 bytes; no spills.  Where the time goes
//   (tools/flash_bwd_ablation.py): the 64 x 64 S and dP products are bound
//   by `ldmatrix` traffic (six loads a warp for eight `mma.sync`, five in
//   dQ), and the dQ kernel forms them a second time.
//
// f32 (`flash_bwd_dq_kernel`, `flash_bwd_dkdv_kernel`): the only
// tensor-core path for fp32 is TF32, which would break the fp32 tolerance,
// so fp32 stays on the CUDA cores: 16 x 16 threads, a thread owns RM rows
// and every 16th column of a tile; operands sit transposed in shared memory
// ([d][row]), a tile read both ways padded to an odd row length so neither
// read conflicts.  The dK/dV block there owns a kv head and walks the q
// heads of its group itself.
//
// Both are deterministic and use no atomics.  Left for the next PR (ROADMAP
// B.1): `wgmma` for the four 64-row products, TMA loads with an `mbarrier`
// ring, and dQ fused into the dK/dV pass.
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
// bf16: tensor cores (mma.sync.m16n8k16), FlashAttention-2's backward tiling
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 256;  // 8 warps, two warpgroups
constexpr int TILE = 64;          // rows of every q and key tile
constexpr int PAD = 8;            // bf16 elements (16 bytes) of padding per shared row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(ptr)));
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
//   B (two n-tiles, or one with .x2) from a row-major [k][n] tile,
//   ldmatrix.trans:                                 + k0 * LD + n0
template <int LD> __device__ __forceinline__ int a_off(int lane) {
  return (lane & 15) * LD + (lane >> 4) * 8;
}
template <int LD> __device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
}
template <int LD> __device__ __forceinline__ int bt_off(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;
}

// Phase 1: a warp's 16 rows x 32 columns of a 64 x 64 score tile (4 x 2 warps).
constexpr int NT1 = TILE / 2 / 8;  // n8 tiles of a warp

// Phase 2: the accumulators of a 64-row tile, D columns, over 8 warps: WM
// warps along the rows (MT m16 tiles each), 8 / WM along the columns (DW
// columns, NT n8 tiles each).  Warps 0-3 (warpgroup 0) own columns [0, D/2).
template <int D> struct Acc {
  static constexpr int WM = D >= 64 ? 2 : 4;
  static constexpr int MT = TILE / 16 / WM;
  static constexpr int DW = D * WM / 8;
  static constexpr int NT = DW / 8;
};

// One k16 step of both phase-1 products: s += A . B^T and dp += A2 . B2^T,
// A and A2 one fragment each, B and B2 32 rows of [n][D] tiles (at b, b2).
template <int D>
__device__ __forceinline__ void score_step(float (&s)[NT1][4], float (&dp)[NT1][4],
                                           const uint32_t (&af)[4], const uint32_t (&af2)[4],
                                           const bf16* b, const bf16* b2, int kk) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int jp = 0; jp < NT1 / 2; ++jp) {
    uint32_t bf[4], bf2[4];
    ldmatrix_x4(bf, b + jp * 16 * LD + kk * 16);
    ldmatrix_x4(bf2, b2 + jp * 16 * LD + kk * 16);
    mma_bf16(s[2 * jp], af, bf[0], bf[1]);
    mma_bf16(s[2 * jp + 1], af, bf[2], bf[3]);
    mma_bf16(dp[2 * jp], af2, bf2[0], bf2[1]);
    mma_bf16(dp[2 * jp + 1], af2, bf2[2], bf2[3]);
  }
}

__device__ __forceinline__ void zero_scores(float (&s)[NT1][4], float (&dp)[NT1][4]) {
#pragma unroll
  for (int j = 0; j < NT1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
}

// s[NT1][4] = A . B^T and dp[NT1][4] = A2 . B2^T over D: A, A2 16 rows of
// [m][D] tiles (at a, a2) ...
template <int D>
__device__ __forceinline__ void mma_scores(float (&s)[NT1][4], float (&dp)[NT1][4],
                                           const bf16* a, const bf16* b, const bf16* a2,
                                           const bf16* b2) {
  zero_scores(s, dp);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4], af2[4];
    ldmatrix_x4(af, a + kk * 16);
    ldmatrix_x4(af2, a2 + kk * 16);
    score_step<D>(s, dp, af, af2, b, b2, kk);
  }
}

// ... or A already in registers, all D / 16 of its fragments.
template <int D>
__device__ __forceinline__ void mma_scores(float (&s)[NT1][4], float (&dp)[NT1][4],
                                           const uint32_t (&af)[D / 16][4], const bf16* b,
                                           const bf16* a2, const bf16* b2) {
  zero_scores(s, dp);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af2[4];
    ldmatrix_x4(af2, a2 + kk * 16);
    score_step<D>(s, dp, af[kk], af2, b, b2, kk);
  }
}

// acc += X . Y over TILE: X this warp's MT*16 rows of a bf16 [row][TILE]
// tile with row length LDX (at x), Y this warp's DW columns of a [TILE][D]
// tile (at y).
template <int D, int LDX>
__device__ __forceinline__ void mma_acc(float (&acc)[Acc<D>::MT][Acc<D>::NT][4], const bf16* x,
                                        const bf16* y) {
  using A = Acc<D>;
  constexpr int LD = D + PAD;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    uint32_t af[A::MT][4];
#pragma unroll
    for (int mt = 0; mt < A::MT; ++mt) ldmatrix_x4(af[mt], x + mt * 16 * LDX + kk * 16);
#pragma unroll
    for (int jp = 0; jp < A::NT / 2; ++jp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, y + kk * 16 * LD + jp * 16);
#pragma unroll
      for (int mt = 0; mt < A::MT; ++mt) {
        mma_bf16(acc[mt][2 * jp], af[mt], bf[0], bf[1]);
        mma_bf16(acc[mt][2 * jp + 1], af[mt], bf[2], bf[3]);
      }
    }
    if constexpr (A::NT % 2 == 1) {  // D = 16: one n8 tile a warp
      uint32_t bf[2];
      ldmatrix_x2_trans(bf, y + kk * 16 * LD + (A::NT - 1) * 8);
#pragma unroll
      for (int mt = 0; mt < A::MT; ++mt) mma_bf16(acc[mt][A::NT - 1], af[mt], bf[0], bf[1]);
    }
  }
}

// 2^x, with results below 2^-126 flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P (log2 units against lse2) and dS of one pair from q.k and dO.v; the
// softcap test is uniform over the block.
__device__ __forceinline__ void p_ds2(const Params& p, bool ok, float qk, float dov, float lse2,
                                      float delta, float& pr, float& ds) {
  if (p.softcap > 0.f) {
    const float t = tanhf(qk * p.scale / p.softcap);
    pr = ok ? ex2(fmaf(p.softcap * t, LOG2E, -lse2)) : 0.f;
    ds = pr * (dov - delta) * (1.f - t * t) * p.scale;
  } else {
    pr = ok ? ex2(fmaf(qk, p.scale * LOG2E, -lse2)) : 0.f;
    ds = pr * (dov - delta) * p.scale;
  }
}

// Rows r0 + g and r0 + g + 8 of a warp's phase-1 tile (NT1 n8 tiles from
// column c0) into a bf16 [row][LDX] shared tile.
template <int LDX>
__device__ __forceinline__ void store_scores(bf16* dst, const float (&x)[NT1][4], int r0, int c0,
                                             int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NT1; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(dst + (r0 + g + 8 * r) * LDX + c0 + 8 * j + 2 * t) =
          pack_bf16(x[j][2 * r], x[j][2 * r + 1]);
}

template <int D>
constexpr size_t dq_smem_bytes() {  // Qs, dOs, Ks[2], Vs[2], dSs, delta_s
  return (size_t)6 * TILE * (D + PAD) * sizeof(bf16) + TILE * (TILE + PAD) * sizeof(bf16) +
         TILE * sizeof(float);
}

// dQ (and Delta): one block of 8 warps per (b, q head, 64-row q tile),
// walking the 64-key tiles that the q tile can see.
// smem: Qs [64][LD] | dOs [64][LD] | Ks [2][64][LD] | Vs [2][64][LD] |
//       dSs [64][64 + PAD] | delta_s [64] f32
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_bwd_dq_mma_kernel(const Params p) {
  using A = Acc<D>;
  constexpr int LD = D + PAD, LDS = TILE + PAD;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;
  bf16* Vs = Ks + 2 * TILE * LD;
  bf16* dSs = Vs + 2 * TILE * LD;
  float* delta_s = reinterpret_cast<float*>(dSs + TILE * LDS);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // late causal q tiles carry more work: first
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = qt * TILE;
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
  const bf16* qb = at<bf16>(p, Q, b, h);
  const bf16* ob = at<bf16>(p, O, b, h);
  const bf16* dob = at<bf16>(p, DO, b, h);
  const bf16* kb = at<bf16>(p, K, b, kvh);
  const bf16* vb = at<bf16>(p, V, b, kvh);

  // the key tiles the q tile can see (the forward's loop bounds)
  const int q_last = min(q0 + TILE, p.Sq) - 1;
  int kt_end = (p.Sk + TILE - 1) / TILE;
  if (p.causal) kt_end = min(kt_end, q_last / TILE + 1);
  int kt_begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) kt_begin = (q0 - p.window + 1) / TILE;

  cp_tile<D>(Qs, qb, p.st[Q][2], q0, TILE, p.Sq);
  cp_tile<D>(dOs, dob, p.st[DO][2], q0, TILE, p.Sq);
  if (kt_begin < kt_end) {
    cp_tile<D>(Ks, kb, p.st[K][2], kt_begin * TILE, TILE, p.Sk);
    cp_tile<D>(Vs, vb, p.st[V][2], kt_begin * TILE, TILE, p.Sk);
  }
  cp_async_commit();

  // Delta = rowsum(dO o) while the copies fly: TPR neighbouring threads a
  // row, each with all its 16-byte loads in flight at once; written for the
  // dK/dV kernel.
  {
    constexpr int CH = D / 8, TPR = CH < 4 ? CH : 4, CPT = CH / TPR;
    static_assert(TILE * TPR <= MMA_THREADS, "one pass over the rows");
    if (tid < TILE * TPR) {  // whole warps
      const int r = tid / TPR, c0 = (tid % TPR) * CPT * 8, row = q0 + r;
      float acc = 0.f;
      if (row < p.Sq) {
        uint4 x[CPT], y[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          x[c] = *reinterpret_cast<const uint4*>(dob + (long long)row * p.st[DO][2] + c0 + 8 * c);
          y[c] = *reinterpret_cast<const uint4*>(ob + (long long)row * p.st[O][2] + c0 + 8 * c);
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x[c]);
          const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(&y[c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 af = __bfloat1622float2(a[i]), of = __bfloat1622float2(o[i]);
            acc = fmaf(af.x, of.x, acc);
            acc = fmaf(af.y, of.y, acc);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (tid % TPR == 0) {
        delta_s[r] = acc;
        if (row < p.Sq) p.delta[row_base + row] = acc;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // Q, dO, the first key tile and Delta are in shared memory

  // phase 1: q rows 16 wr + [0, 16), keys 32 wc + [0, 32) of each key tile
  const int wr = warp & 3, wc = warp >> 2;
  const int row_a = q0 + wr * 16 + g;  // this lane's rows: row_a, row_a + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < p.Sq ? p.lse[row_base + row] * LOG2E : 0.f;
    dlt[r] = delta_s[wr * 16 + g + 8 * r];
  }
  // this warp's rows of Q are the same in every key tile: their A
  // fragments stay in registers for the whole walk
  uint32_t q_frag[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(q_frag[kk], Qs + wr * 16 * LD + a_off<LD>(lane) + kk * 16);
  const bf16* do_a = dOs + wr * 16 * LD + a_off<LD>(lane);
  const int c_w = wc * (TILE / 2);
  // phase 2: q rows row2 + [0, 16 MT), dQ columns col2 + [0, DW)
  const int row2 = (warp % A::WM) * A::MT * 16, col2 = (warp / A::WM) * A::DW;

  float dq[A::MT][A::NT][4];
#pragma unroll
  for (int mt = 0; mt < A::MT; ++mt)
#pragma unroll
    for (int j = 0; j < A::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[mt][j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed, and every warp is done with tile kt - 1
    if (kt + 1 < kt_end) {  // the next tile goes into the other buffer
      cp_tile<D>(Ks + (buf ^ 1) * TILE * LD, kb, p.st[K][2], (kt + 1) * TILE, TILE, p.Sk);
      cp_tile<D>(Vs + (buf ^ 1) * TILE * LD, vb, p.st[V][2], (kt + 1) * TILE, TILE, p.Sk);
      cp_async_commit();
    }
    const bf16* Kt = Ks + buf * TILE * LD;
    const bf16* Vt = Vs + buf * TILE * LD;

    float s[NT1][4], dp[NT1][4];
    mma_scores<D>(s, dp, q_frag, Kt + c_w * LD + b_off<LD>(lane), do_a,
                  Vt + c_w * LD + b_off<LD>(lane));
    const int k0 = kt * TILE;
    const bool edge = q0 + TILE > p.Sq || k0 + TILE > p.Sk ||
                      (p.causal && k0 + TILE - 1 > q0) ||
                      (p.window > 0 && k0 <= q0 + TILE - 1 - p.window);
#pragma unroll
    for (int j = 0; j < NT1; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = !edge || visible(p, row_a + 8 * r, k0 + c_w + 8 * j + 2 * t + (e & 1));
        float pr;
        p_ds2(p, ok, s[j][e], dp[j][e], lse2[r], dlt[r], pr, s[j][e]);  // s := dS
      }
    }
    store_scores<LDS>(dSs, s, wr * 16, c_w, lane);
    __syncthreads();  // dS is whole
    mma_acc<D, LDS>(dq, dSs + row2 * LDS + a_off<LDS>(lane), Kt + col2 + bt_off<LD>(lane));
  }
  cp_async_wait_all();  // no copy outlives the block, even with no key tile to see

  bf16* dqb = static_cast<bf16*>(p.dq) + b * p.st[DQ][0] + h * p.st[DQ][1];
#pragma unroll
  for (int mt = 0; mt < A::MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row2 + mt * 16 + g + 8 * r;
      if (row >= p.Sq) continue;
      bf16* orow = dqb + (long long)row * p.st[DQ][2] + col2 + 2 * t;
#pragma unroll
      for (int j = 0; j < A::NT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(dq[mt][j][2 * r], dq[mt][j][2 * r + 1]);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {  // Ks, Vs, Qs[2], dOs[2], Ps, dSs, lse_s[2], delta_s[2]
  return (size_t)6 * TILE * (D + PAD) * sizeof(bf16) + 2 * TILE * (TILE + PAD) * sizeof(bf16) +
         4 * TILE * sizeof(float);
}

// dK and dV of one q head: one block of 8 warps per (b, q head, 64-key
// tile), walking the 64-row q tiles that can see the key tile.  With one q
// head per kv head the block writes dK and dV in bf16; otherwise its fp32
// parts (B, Hq, Sk, D), which group_sum_kernel sums over the group.
// smem: Ks [64][LD] | Vs [64][LD] | Qs [2][64][LD] | dOs [2][64][LD] |
//       Ps [64][64 + PAD] (P^T) | dSs [64][64 + PAD] (dS^T) |
//       lse_s [2][64] | delta_s [2][64]
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_bwd_dkdv_mma_kernel(const Params p, float* dk_part, float* dv_part) {
  using A = Acc<D>;
  constexpr int LD = D + PAD, LDS = TILE + PAD;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + TILE * LD;
  bf16* Qs = Vs + TILE * LD;
  bf16* dOs = Qs + 2 * TILE * LD;
  bf16* Ps = dOs + 2 * TILE * LD;
  bf16* dSs = Ps + TILE * LDS;
  float* lse_s = reinterpret_cast<float*>(dSs + TILE * LDS);
  float* delta_s = lse_s + 2 * TILE;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kt = blockIdx.z;  // early causal key tiles carry more work: first
  const int group = p.Hq / p.Hkv, kvh = h / group;
  const int k0 = kt * TILE;
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
  const bf16* qb = at<bf16>(p, Q, b, h);
  const bf16* dob = at<bf16>(p, DO, b, h);

  // the q tiles that can see the key tile
  const int k_last = min(k0 + TILE, p.Sk) - 1;
  int q_end = p.Sq;
  if (p.window > 0) q_end = min(q_end, k_last + p.window);
  const int qt_begin = p.causal ? k0 / TILE : 0;
  const int qt_end = (q_end + TILE - 1) / TILE;

  // the q tile qt into buffer buf, all by cp.async: Q, dO, and the rows'
  // LSE and Delta (zero past Sq)
  auto stage = [&](int qt, int buf) {
    cp_tile<D>(Qs + buf * TILE * LD, qb, p.st[Q][2], qt * TILE, TILE, p.Sq);
    cp_tile<D>(dOs + buf * TILE * LD, dob, p.st[DO][2], qt * TILE, TILE, p.Sq);
    if (tid < 2 * TILE) {
      const int r = tid % TILE, row = qt * TILE + r;
      const float* src = (tid < TILE ? p.lse : p.delta) + row_base;
      cp_async4((tid < TILE ? lse_s : delta_s) + buf * TILE + r,
                row < p.Sq ? src + row : src, row < p.Sq);
    }
  };

  cp_tile<D>(Ks, at<bf16>(p, K, b, kvh), p.st[K][2], k0, TILE, p.Sk);
  cp_tile<D>(Vs, at<bf16>(p, V, b, kvh), p.st[V][2], k0, TILE, p.Sk);
  if (qt_begin < qt_end) stage(qt_begin, 0);
  cp_async_commit();

  // phase 1: keys 16 wr + [0, 16), q columns 32 wc + [0, 32) of each q tile
  const int wr = warp & 3, wc = warp >> 2;
  const bf16* k_a = Ks + wr * 16 * LD + a_off<LD>(lane);
  const bf16* v_a = Vs + wr * 16 * LD + a_off<LD>(lane);
  const int key_a = k0 + wr * 16 + g;  // this lane's keys: key_a, key_a + 8
  const int c_w = wc * (TILE / 2);
  // phase 2: keys row2 + [0, 16 MT), dK/dV columns col2 + [0, DW)
  const int row2 = (warp % A::WM) * A::MT * 16, col2 = (warp / A::WM) * A::DW;

  float dk[A::MT][A::NT][4], dv[A::MT][A::NT][4];
#pragma unroll
  for (int mt = 0; mt < A::MT; ++mt)
#pragma unroll
    for (int j = 0; j < A::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mt][j][e] = dv[mt][j][e] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int buf = (qt - qt_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile qt has landed, and every warp is done with tile qt - 1
    if (qt + 1 < qt_end) {
      stage(qt + 1, buf ^ 1);
      cp_async_commit();
    }
    const bf16* Qt = Qs + buf * TILE * LD;
    const bf16* dOt = dOs + buf * TILE * LD;
    const float* lse_t = lse_s + buf * TILE;
    const float* dl_t = delta_s + buf * TILE;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns q
    float s[NT1][4], dp[NT1][4];
    mma_scores<D>(s, dp, k_a, Qt + c_w * LD + b_off<LD>(lane), v_a,
                  dOt + c_w * LD + b_off<LD>(lane));
    const int q0 = qt * TILE;
    const bool edge = q0 + TILE > p.Sq || k0 + TILE > p.Sk ||
                      (p.causal && q0 < k0 + TILE - 1) ||
                      (p.window > 0 && q0 + TILE - 1 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < NT1; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c_w + 8 * j + 2 * t + (e & 1);
        const bool ok = !edge || visible(p, q0 + c, key_a + 8 * (e >> 1));
        p_ds2(p, ok, s[j][e], dp[j][e], lse_t[c] * LOG2E, dl_t[c], s[j][e], dp[j][e]);  // P^T, dS^T
      }
    }
    store_scores<LDS>(Ps, s, wr * 16, c_w, lane);
    store_scores<LDS>(dSs, dp, wr * 16, c_w, lane);
    __syncthreads();  // P^T and dS^T are whole
    mma_acc<D, LDS>(dv, Ps + row2 * LDS + a_off<LDS>(lane), dOt + col2 + bt_off<LD>(lane));
    mma_acc<D, LDS>(dk, dSs + row2 * LDS + a_off<LDS>(lane), Qt + col2 + bt_off<LD>(lane));
  }
  cp_async_wait_all();

  // this warp's rows of one accumulator: bf16 into dK/dV, or the head's
  // fp32 part
  auto store = [&](const float (&acc)[A::MT][A::NT][4], int which, void* out, float* part) {
#pragma unroll
    for (int mt = 0; mt < A::MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = k0 + row2 + mt * 16 + g + 8 * r;
        if (row >= p.Sk) continue;
        if (group == 1) {
          bf16* orow = static_cast<bf16*>(out) + b * p.st[which][0] + kvh * p.st[which][1] +
                       (long long)row * p.st[which][2] + col2 + 2 * t;
#pragma unroll
          for (int j = 0; j < A::NT; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
                __floats2bfloat162_rn(acc[mt][j][2 * r], acc[mt][j][2 * r + 1]);
        } else {
          float* orow = part + (((long long)b * p.Hq + h) * p.Sk + row) * D + col2 + 2 * t;
#pragma unroll
          for (int j = 0; j < A::NT; ++j)
            *reinterpret_cast<float2*>(orow + 8 * j) =
                make_float2(acc[mt][j][2 * r], acc[mt][j][2 * r + 1]);
        }
      }
    }
  };
  store(dk, DK, p.dk, dk_part);
  store(dv, DV, p.dv, dv_part);
}

// dK and dV (B, Hkv, Sk, D) bf16 = the sums of their fp32 parts
// (B, Hq, Sk, D) over the q heads of each kv group, in head order; four
// columns a thread.
__global__ void group_sum_kernel(const Params p, const float* dk_part, const float* dv_part,
                                 int B, int D) {
  const long long n = (long long)B * p.Hkv * p.Sk * D / 4;
  const int group = p.Hq / p.Hkv;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = 4 * i;
    const int d = e % D;
    const int s = (e / D) % p.Sk;
    const int kvh = (e / ((long long)D * p.Sk)) % p.Hkv;
    const int b = e / ((long long)D * p.Sk * p.Hkv);
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int hg = 0; hg < group; ++hg) {
      const long long off = (((long long)b * p.Hq + kvh * group + hg) * p.Sk + s) * D + d;
      const float4 x = *reinterpret_cast<const float4*>(dk_part + off);
      const float4 y = *reinterpret_cast<const float4*>(dv_part + off);
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(
        static_cast<bf16*>(p.dk) + b * p.st[DK][0] + kvh * p.st[DK][1] + s * p.st[DK][2] + d);
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(
        static_cast<bf16*>(p.dv) + b * p.st[DV][0] + kvh * p.st[DV][1] + s * p.st[DV][2] + d);
    ok[0] = __floats2bfloat162_rn(sk.x, sk.y);
    ok[1] = __floats2bfloat162_rn(sk.z, sk.w);
    ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
    ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
  }
}

// One dQ launch, one dK/dV launch and, for GQA/MQA, one group sum.
template <int D>
cudaError_t launch_bf16(const Params& p, int B, float* dk_part, float* dv_part,
                        cudaStream_t stream) {
  const size_t dq_smem = dq_smem_bytes<D>(), kv_smem = dkdv_smem_bytes<D>();
  auto dq_kern = flash_bwd_dq_mma_kernel<D>;
  auto kv_kern = flash_bwd_dkdv_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return err;
  dq_kern<<<dim3(p.Hq, B, (p.Sq + TILE - 1) / TILE), MMA_THREADS, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kv_kern<<<dim3(p.Hq, B, (p.Sk + TILE - 1) / TILE), MMA_THREADS, kv_smem, stream>>>(
      p, dk_part, dv_part);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.Hq == p.Hkv) return err;
  group_sum_kernel<<<132 * 8, 256, 0, stream>>>(p, dk_part, dv_part, B, D);
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
// then the dK/dV kernel (and for bf16 GQA one group sum); returns the first
// cudaError_t (0 on success).
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
