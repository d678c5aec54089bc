// The WKV6 recurrence (RWKV-6 "Finch" time mixing) for Hopper (sm_90a), in
// its chunked form, bound to PyTorch with ctypes.
//
// Replaces the Pallas TPU kernel `_wkv6_kernel` / `wkv6` in
// src/repro/kernels/rwkv6_wkv.py, over its whole contract: per (batch, head),
// with the state S (K x V) in fp32,
//     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T
// r/k/v in f32 or bf16, log_w/u/s0 in f32; y comes out in r's dtype (or in
// f32 from bf16 r/k/v, as the JAX rwkv6 model keeps y up to its group norm)
// and the final state in f32.  Any T >= 1 (prefill, ragged lengths, the
// decode step T = 1); K = V in {16, 32, 64}.
//
// What bounds it on the H100: bytes.  Every input is read once and every
// output written once: at the serving shape of rwkv6-1.6b (B=4, H=32,
// T=1024, K=V=64, bf16 r/k/v, fp32 y) that is 121.6 MB, 0.0363 ms at
// 3.35 TB/s; the ~4 K V operations per token and head (2.15 GFLOP) take
// 0.0321 ms on the fp32 CUDA cores.
//
// What held the token-by-token design back: one block per (b, h) walked
// all T = 1024 tokens as a chain of dependent fp32 updates, and B*H = 128
// blocks left most of the 132 SMs with one block of 8 warps, so each token
// step's latency was exposed (0.327 ms, 9x the bound).
//
// What this design does (the Pallas kernel's algorithm, laid out for the card):
//   * Each block walks T in chunks of C = 32 tokens, so the serial chain is
//     T/C chunk steps.  Per chunk, with cl the inclusive and cl_prev the
//     exclusive cumulative sum of log_w (fp32, `expf`):
//         inter = (r . exp(cl_prev)) S_in
//         A     = the lower triangle of the chunk's (C, C) token matrix:
//                 its off-diagonal 16 x 16 block factorised about
//                 g = cl_prev at the second sub-chunk's start,
//                 (r_t . exp(cl_prev_t - g)) (k_j . exp(g - cl_j))^T,
//                 its two diagonal 16 x 16 blocks elementwise on the CUDA
//                 cores, sum_k r_t k_j exp(cl_prev_t - cl_j), with
//                 r_t . (u . k_t) on the diagonal
//         y     = inter + A v
//         S_out = diag(exp(cl_C)) S_in + (k . exp(cl_C - cl))^T v
//     Every exponent is <= 0, so nothing overflows at log_w = -50.  Within a
//     row of a diagonal block exp(cl_prev_t - cl_j) = w_{t-1} .. w_{j+1}
//     (w = exp(log_w)) is carried down the row as a product of factors
//     <= 1, so those 240 entries per chunk need no exponential.
//   * The four products run on `mma.sync.m16n8k8` TF32 in a 3x split:
//     hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and hi.hi + hi.lo +
//     lo.hi accumulate in fp32.  One TF32 pass (10-bit mantissas) misses the
//     fp32 tolerance of 2e-4 by ~55x at T = 1024, and a bf16 split misses
//     it at C = 64; 3xTF32 at C = 32 meets it with ~3x margin (the CPU
//     mirror `ref.wkv6_chunked_reference`, tests/test_torch_wkv6_chunked.py).
//     A bf16 v is exact in TF32, so its lo term is zero and skipped.
//   * Grid (V/BV, H, B) with BV = min(K, 64): one block of 16 warps per
//     (b, h) owns the whole state in shared memory, 128 blocks at the
//     serving shape.  Columns of S are independent, so V could be split over
//     blocks, but every block would then redo the chunk's operands and A:
//     tools/wkv6_ablation.py measured 0.599 ms with BV = 16 (512 blocks of
//     16 warps) and 0.327 ms with BV = 32, against 0.194 ms (NVIDIA H100
//     80GB HBM3, 700 W).
//   * Per chunk, four barriers: the staged chunk has landed; each thread
//     sums log_w over its tokens (the parts' sums give cl_prev, g and cl_C
//     in one order for every thread); the fp32 operands are made; A, inter
//     and (k . exp(cl_C - cl))^T v are done.  The 32 rows of A's diagonal
//     blocks take 16 threads each, two rows per warp, so warps 8 h + q hold
//     rows of growing length with q.  Warps q < 4 (short rows) compute the
//     y tiles, inter and then A v; warps q >= 4 one 16-row band of the state
//     update each; warps q = 0 also A's off-diagonal block.  One A fragment
//     feeds every n-tile of a warp.
//   * r, k, log_w and v of the next chunk are copied with 16-byte
//     `cp.async` (zero-filled past T) while the current chunk's products
//     run.  A ragged last chunk is padded with zeros (log_w = 0), and no y
//     row past T is written.  Inputs that are not 16-byte aligned are
//     staged with plain loads instead.
//   * Strides come from the wrapper, so the model layout (B, T, H, K) is read
//     and y written in place.  The final state may be written over s0 (the
//     layer's cache): a block reads its slice of s0 before it writes it,
//     and no other block touches that slice.
//   * Sequences shorter than C (the decode step) go to the token-by-token
//     kernel below: at T = 1 the chunked kernel still runs a whole chunk
//     (tools/wkv6_ablation.py, variant chunk_only, times both).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int C = 32;         // tokens per chunk
constexpr int SUB = 16;       // tokens per sub-chunk (one mma m-tile)
constexpr int MAX_BV = 64;    // state columns per block, at most
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int LDA = C + 4;    // row stride of A (floats): conflict-free fragments

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
  bool aligned;  // every staged row starts on 16 bytes: cp.async may copy it
};

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to 21 mantissa bits, each part a TF32 value.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a b: a 16x8 (row), b 8x8 (col), c 16x8 fp32, operands TF32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32): lane = 4 g + t.  a holds
// (row, col) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b holds
// (k, n) = (t, g), (t + 4, g); the accumulator c holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
//
// c[n] += A B_n over one k-step of 8 in 3xTF32, for NT n-tiles that share
// A.  A(row, col) is a[row * ars + col * acs] and B_n(k, col) is
// b[k * bks + (8 n + col) * bns] (the strides let one helper read a matrix
// or its transpose; bnt = 8 bns).  hi.hi goes to c and the two cross terms
// to cl, so the products of one tile form two dependency chains; the
// caller adds cl to c at the end.  With b_exact B is exact in TF32 (a bf16
// value): its lo part is zero and that product is skipped.
template <int NT, bool b_exact>
__device__ __forceinline__ void mma3(float (&c)[NT][4], float (&cl)[NT][4], const float* a,
                                     int ars, int acs, const float* b, int bks, int bns, int bnt,
                                     int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
  split(a[g * ars + t * acs], ah[0], al[0]);
  split(a[(g + 8) * ars + t * acs], ah[1], al[1]);
  split(a[g * ars + (t + 4) * acs], ah[2], al[2]);
  split(a[(g + 8) * ars + (t + 4) * acs], ah[3], al[3]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float* bn = b + n * bnt;
    uint32_t bh[2], bl[2];
    if (b_exact) {
      bh[0] = tf32(bn[t * bks + g * bns]);
      bh[1] = tf32(bn[(t + 4) * bks + g * bns]);
    } else {
      split(bn[t * bks + g * bns], bh[0], bl[0]);
      split(bn[(t + 4) * bks + g * bns], bh[1], bl[1]);
    }
    mma_tf32(cl[n], al, bh[0], bh[1]);
    if (!b_exact) mma_tf32(cl[n], ah, bl[0], bl[1]);
    mma_tf32(c[n], ah, bh[0], bh[1]);
  }
}

// State columns per block: all of them (K <= MAX_BV); tools/wkv6_ablation.py
// builds fewer to measure what splitting V over blocks costs.
template <int K> constexpr int block_cols() { return K < MAX_BV ? K : MAX_BV; }

// Shared memory of one block, in floats (every array starts on 16 bytes).
// Row strides are padded so that the mma fragments and the float4 reads of
// the diagonal blocks fall on distinct banks.
template <int K, typename T>
struct Smem {
  static constexpr int BV = block_cols<K>();
  static constexpr int LDK = K + 4;   // by token: r, k, w and the scaled operands
  static constexpr int LDKT = K + 8;  // k . exp(cl_C - cl), read transposed
  static constexpr int LDV = BV + 8;  // v and S
  static constexpr int RS = 0;                  // r (C, K)
  static constexpr int KS = RS + C * LDK;       // k (C, K)
  static constexpr int WS = KS + C * LDK;       // w = exp(log_w) (C, K)
  static constexpr int RD = WS + C * LDK;       // r . exp(cl_prev) (C, K)
  static constexpr int KD = RD + C * LDK;       // k . exp(cl_C - cl) (C, K)
  static constexpr int RQ = KD + C * LDKT;      // r . exp(cl_prev - g), second sub-chunk
  static constexpr int KQ = RQ + SUB * LDK;     // k . exp(g - cl), first sub-chunk
  static constexpr int AS = KQ + SUB * LDK;     // A (C, C)
  static constexpr int VS = AS + C * LDA;       // v (C, BV)
  static constexpr int SS = VS + C * LDV;       // S (K, BV)
  static constexpr int DK = SS + K * LDV;       // exp(cl_C) (K)
  static constexpr int US = DK + K;             // u (K)
  static constexpr int PS = US + K;             // log_w summed over each thread's tokens
  static constexpr int TW = PS + THREADS;       // staged log_w (C, K)
  static constexpr int FLOATS = TW + C * K;     // then staged r, k (C, K) and v (C, BV) as T
  static constexpr size_t BYTES = FLOATS * sizeof(float) + (2 * C * K + C * BV) * sizeof(T);
};

// Stage rows t0 .. t0 + C - 1 (COLS elements each, `st` apart) of src into
// dst, zeros past T: 16-byte cp.async pieces when aligned, else plain loads.
template <typename E, int COLS>
__device__ __forceinline__ void stage(E* dst, const E* src, long long st, int t0, int T,
                                      bool aligned, int tid) {
  if (aligned) {
    constexpr int PER = 16 / sizeof(E), PIECES = COLS / PER;
    for (int i = tid; i < C * PIECES; i += THREADS) {
      const int row = i / PIECES, pc = i % PIECES;
      const bool ok = t0 + row < T;
      cp_async16(dst + row * COLS + pc * PER,
                 ok ? src + (long long)(t0 + row) * st + pc * PER : src, ok);
    }
  } else {
    for (int i = tid; i < C * COLS; i += THREADS) {
      const int row = i / COLS, col = i % COLS;
      dst[i] = t0 + row < T ? src[(long long)(t0 + row) * st + col] : from_float<E>(0.f);
    }
  }
}

// N consecutive floats from shared memory (N = 1, 2 or 4, aligned).
template <int N> struct Vec { float v[N]; };
template <int N>
__device__ __forceinline__ Vec<N> ldv(const float* p) {
  Vec<N> r;
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r.v[0] = t.x; r.v[1] = t.y;
  } else {
    r.v[0] = *p;
  }
  return r;
}

constexpr int KSLICES = THREADS / C;  // threads that share one row of A's diagonal blocks

// T: the type of r, k and v; TY: the type of y.
template <typename T, typename TY, int K>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_chunk_kernel(const Params p) {
  using L = Smem<K, T>;
  constexpr int BV = L::BV, LDK = L::LDK, LDKT = L::LDKT, LDV = L::LDV;
  constexpr bool V_EXACT = std::is_same<T, __nv_bfloat16>::value;  // bf16 v is exact in TF32
  constexpr int TP = C * K / THREADS;  // operand prep: tokens per thread
  constexpr int PARTS = C / TP;        // operand prep: threads per channel
  constexpr int NB = BV / 8;                          // 8-column tiles of the block's slice
  constexpr int YN = NB >= 8 ? NB / 4 : 1;            // y tiles (16 x 8) per y warp
  constexpr int SN = NB >= 2 ? NB / 2 : 1;            // state tiles per state warp
  constexpr int KSL = K / KSLICES, VW = KSL < 4 ? KSL : 4;  // diagonal rows: channels per thread
  static_assert(C == 2 * SUB && SUB % TP == 0 && C * KSLICES == THREADS,
                "the prep and the diagonal rows fit the block");

  extern __shared__ __align__(16) float sm[];
  float* Rs = sm + L::RS;  float* Ks = sm + L::KS;  float* Ws = sm + L::WS;
  float* Rd = sm + L::RD;  float* Kd = sm + L::KD;  float* Rq = sm + L::RQ;
  float* Kq = sm + L::KQ;  float* As = sm + L::AS;
  float* Vs = sm + L::VS;  float* Ss = sm + L::SS;  float* Dk = sm + L::DK;
  float* Us = sm + L::US;  float* Ps = sm + L::PS;  float* Tw = sm + L::TW;
  T* Tr = reinterpret_cast<T*>(sm + L::FLOATS);
  T* Tk = Tr + C * K;
  T* Tv = Tk + C * K;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * BV, h = blockIdx.y, b = blockIdx.z;
  const T* rb = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + j0;
  const float* wb = p.lw + b * p.w_sb + h * p.w_sh;
  TY* yb = static_cast<TY*>(p.y) + b * p.y_sb + h * p.y_sh + j0;
  const long long st = ((long long)b * p.H + h) * K * K;  // s0, s_out: contiguous (B, H, K, V)

  auto fetch = [&](int t0) {
    stage<T, K>(Tr, rb, p.r_st, t0, p.T, p.aligned, tid);
    stage<T, K>(Tk, kb, p.k_st, t0, p.T, p.aligned, tid);
    stage<T, BV>(Tv, vb, p.v_st, t0, p.T, p.aligned, tid);
    stage<float, K>(Tw, wb, p.w_st, t0, p.T, p.aligned, tid);
    cp_async_commit();
  };
  fetch(0);
  for (int i = tid; i < K * BV; i += THREADS)
    Ss[(i / BV) * LDV + i % BV] = p.s0[st + (i / BV) * K + j0 + i % BV];
  for (int i = tid; i < K; i += THREADS) Us[i] = p.u[h * K + i];
  for (int i = tid; i < C * LDA; i += THREADS) As[i] = 0.f;  // A's upper triangle stays 0

  // This thread's part of A's diagonal blocks: row dt, channels
  // VW (dkq + KSLICES i) ..; the warp's rows end at drows.
  const int dt = tid / KSLICES, dtl = dt % SUB, dkq = tid % KSLICES;
  const int drows = dtl | (32 / KSLICES - 1);
  // Roles, set against the diagonal rows each warp holds (rows 2 q, 2 q + 1
  // of sub-chunk `half` for warp 8 half + q: longer for larger q).  Warps q < 4
  // compute y tiles: tokens 16 ym .., YN tiles of columns from 8 yn0; warps
  // q >= 4 one 16-row band sk of the state update, SN tiles of columns from
  // 8 sn0; warps q = 0 also one half of A's off-diagonal block.
  const int half = warp / 8, q = warp % 8;
  const int yi = half * 4 + q, si = half * 4 + q - 4;
  const bool is_y = q < 4 && yi < 2 * NB / YN, is_s = q >= 4 && si < (K / 16) * (NB / SN);
  const int ym = yi / (NB / YN), yn0 = yi % (NB / YN) * YN;
  const int sk = si / (NB / SN), sn0 = si % (NB / SN) * SN;

  const int n_chunks = (p.T + C - 1) / C;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * C;
    cp_async_wait_all();
    __syncthreads();  // chunk c is staged; chunk c-1 is done with every array

    {  // fp32 operands of the chunk: thread (part, kk) takes channel kk, tokens tb .. tb+TP-1
      const int kk = tid % K, part = tid / K, tb = part * TP;
      float lws[TP], inner[TP];  // log_w and its running sum over this thread's tokens
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        lws[i] = Tw[(tb + i) * K + kk];
        inner[i] = (i ? inner[i - 1] : 0.f) + lws[i];
      }
      Ps[part * K + kk] = inner[TP - 1];
      __syncthreads();
      // cl_prev at tb, g = cl_prev at SUB and cl_C: one running sum over the
      // parts, the same in every thread, so that g and cl_C are bit for bit
      // the cl of tokens SUB - 1 and C - 1.  Summed in another order, cl_C
      // and cl disagree by a rounding, which exp(cl_C - cl) and exp(cl_C)
      // carry into the state (tools/wkv6_ablation.py, variant cl_reordered:
      // several times the error of y and the state).
      float pre = 0.f, gref = 0.f, total = 0.f;
#pragma unroll
      for (int i = 0; i < PARTS; ++i) {
        if (i == part) pre = total;
        if (i == SUB / TP) gref = total;
        total += Ps[i * K + kk];
      }
      float cl[TP], w[TP];
      // exp(cl_prev) and, in the second sub-chunk, exp(cl_prev - g) at token tb
      float er = expf(pre), eq = tb >= SUB ? expf(pre - gref) : 0.f;
#pragma unroll
      for (int i = 0; i < TP; ++i) {  // the r side: exp(cl_prev_{t+1}) = exp(cl_prev_t) w_t
        const int tt = tb + i;
        cl[i] = pre + inner[i];
        w[i] = expf(lws[i]);
        const float rv = to_float(Tr[tt * K + kk]);
        Rs[tt * LDK + kk] = rv;
        Ws[tt * LDK + kk] = w[i];
        Rd[tt * LDK + kk] = rv * er;
        if (tb >= SUB) Rq[(tt - SUB) * LDK + kk] = rv * eq;
        er *= w[i];
        eq *= w[i];
      }
      // exp(cl_C - cl) and, in the first sub-chunk, exp(g - cl) at the last token
      float ed = expf(total - cl[TP - 1]), ek = tb < SUB ? expf(gref - cl[TP - 1]) : 0.f;
#pragma unroll
      for (int i = TP - 1; i >= 0; --i) {  // the k side: exp(x - cl_{t-1}) = exp(x - cl_t) w_t
        const int tt = tb + i;
        const float kv = to_float(Tk[tt * K + kk]);
        Ks[tt * LDK + kk] = kv;
        Kd[tt * LDKT + kk] = kv * ed;
        if (tb < SUB) Kq[tt * LDK + kk] = kv * ek;
        ed *= w[i];
        ek *= w[i];
      }
      if (tb == 0) Dk[kk] = expf(total);
      for (int i = tid; i < C * BV; i += THREADS) Vs[(i / BV) * LDV + i % BV] = to_float(Tv[i]);
    }
    __syncthreads();  // operands ready; the staging buffers are free
    if (c + 1 < n_chunks) fetch(t0 + C);  // lands while chunk c runs

    {  // A's diagonal blocks on the CUDA cores: A[t][j] = sum_k r_t k_j D_tj with
       // D_tj = exp(cl_prev_t - cl_j) = w_{j+1} .. w_{t-1}, carried down the
       // row (D_{t,t-1} = 1, D_{t,j-1} = D_tj w_j: every factor <= 1, no
       // exponential); A[t][t] = r_t . (u . k_t).  Slices summed by shuffles.
      float acc[SUB - 1] = {}, bonus = 0.f;
#pragma unroll
      for (int i = 0; i < KSL / VW; ++i) {
        const int kk = VW * (dkq + KSLICES * i);
        const Vec<VW> r = ldv<VW>(Rs + dt * LDK + kk), uu = ldv<VW>(Us + kk);
        const Vec<VW> kt = ldv<VW>(Ks + dt * LDK + kk);
        Vec<VW> d;
#pragma unroll
        for (int x = 0; x < VW; ++x) {
          bonus = fmaf(r.v[x] * uu.v[x], kt.v[x], bonus);
          d.v[x] = 1.f;
        }
#pragma unroll
        for (int e = 0; e < SUB - 1; ++e) {
          if (e >= drows) break;  // uniform in the warp
          if (e < dtl) {
            const int j = dt - 1 - e;
            const Vec<VW> kj = ldv<VW>(Ks + j * LDK + kk), wj = ldv<VW>(Ws + j * LDK + kk);
#pragma unroll
            for (int x = 0; x < VW; ++x) {
              acc[e] = fmaf(r.v[x] * kj.v[x], d.v[x], acc[e]);
              d.v[x] *= wj.v[x];
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < SUB - 1; ++e) {
        if (e >= drows) break;
#pragma unroll
        for (int m = 1; m < KSLICES; m <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], m);
      }
#pragma unroll
      for (int m = 1; m < KSLICES; m <<= 1) bonus += __shfl_xor_sync(0xffffffffu, bonus, m);
      if (dkq == 0) {
#pragma unroll
        for (int e = 0; e < SUB - 1; ++e)
          if (e < dtl) As[dt * LDA + dt - 1 - e] = acc[e];
        As[dt * LDA + dt] = bonus;
      }
    }
    if (q == 0) {  // A's off-diagonal block: Rq Kq^T, 8 columns per warp
      const int n0 = half * 8;
      float oa[1][4] = {}, ol[1][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < K; k0 += 8)
        mma3<1, false>(oa, ol, Rq + k0, LDK, 1, Kq + n0 * LDK + k0, 1, LDK, 0, lane);
      float* a = As + (SUB + g) * LDA + n0 + 2 * tq;
      a[0] = oa[0][0] + ol[0][0];
      a[1] = oa[0][1] + ol[0][1];
      a[8 * LDA] = oa[0][2] + ol[0][2];
      a[8 * LDA + 1] = oa[0][3] + ol[0][3];
    }
    float ya[YN][4] = {}, yl[YN][4] = {}, sa[SN][4] = {}, sl[SN][4] = {};
    if (is_y) {  // inter = (r . exp(cl_prev)) S_in
#pragma unroll 2
      for (int k0 = 0; k0 < K; k0 += 8)
        mma3<YN, false>(ya, yl, Rd + ym * 16 * LDK + k0, LDK, 1, Ss + k0 * LDV + yn0 * 8, LDV, 1,
                        8, lane);
    }
    if (is_s) {  // (k . exp(cl_C - cl))^T v for rows sk*16 .., Kd read transposed
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 8)
        mma3<SN, V_EXACT>(sa, sl, Kd + k0 * LDKT + sk * 16, 1, LDKT, Vs + k0 * LDV + sn0 * 8, LDV,
                          1, 8, lane);
    }
    __syncthreads();  // A complete; every read of S_in done

    if (is_y) {  // y = inter + A v, over the tokens up to the tile's last
      for (int k0 = 0; k0 < (ym + 1) * SUB; k0 += 8)
        mma3<YN, V_EXACT>(ya, yl, As + ym * 16 * LDA + k0, LDA, 1, Vs + k0 * LDV + yn0 * 8, LDV,
                          1, 8, lane);
      const int tok = t0 + ym * 16 + g;
#pragma unroll
      for (int n = 0; n < YN; ++n) {
        const int col = (yn0 + n) * 8 + 2 * tq;
        if (tok < p.T) {
          yb[(long long)tok * p.y_st + col] = from_float<TY>(ya[n][0] + yl[n][0]);
          yb[(long long)tok * p.y_st + col + 1] = from_float<TY>(ya[n][1] + yl[n][1]);
        }
        if (tok + 8 < p.T) {
          yb[(long long)(tok + 8) * p.y_st + col] = from_float<TY>(ya[n][2] + yl[n][2]);
          yb[(long long)(tok + 8) * p.y_st + col + 1] = from_float<TY>(ya[n][3] + yl[n][3]);
        }
      }
    }
    if (is_s) {  // S_out = diag(exp(cl_C)) S_in + (k . exp(cl_C - cl))^T v
      const int row = sk * 16 + g;
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        float* s0r = Ss + row * LDV + (sn0 + n) * 8 + 2 * tq;
        float* s8r = s0r + 8 * LDV;
        s0r[0] = fmaf(Dk[row], s0r[0], sa[n][0] + sl[n][0]);
        s0r[1] = fmaf(Dk[row], s0r[1], sa[n][1] + sl[n][1]);
        s8r[0] = fmaf(Dk[row + 8], s8r[0], sa[n][2] + sl[n][2]);
        s8r[1] = fmaf(Dk[row + 8], s8r[1], sa[n][3] + sl[n][3]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < K * BV; i += THREADS)
    p.s_out[st + (i / BV) * K + j0 + i % BV] = Ss[(i / BV) * LDV + i % BV];
}

// The decode kernel (T < C): the token-by-token recurrence of the first
// port.  One block per (b, h) of K K / 16 threads holds S in registers
// (thread (j, s) owns column j, rows s, s + K/16, ..), stages a chunk of
// K/2 tokens in shared memory as f32 with the next chunk's loads in flight,
// and sums y_t[j] with shuffles.  At T = 1 it takes about half the time of
// the chunked kernel, whose fixed cost per chunk does not shrink with T.
constexpr int ROWS = 16;  // state rows held by one thread

template <typename T, typename TY, int K>
__global__ void __launch_bounds__(K * K / ROWS)
wkv6_step_kernel(const Params p) {
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
cudaError_t launch_step(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid(p.H, B);
  wkv6_step_kernel<T, TY, K><<<grid, K * K / ROWS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TY, int K>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  if (p.T < C) return launch_step<T, TY, K>(p, B, stream);
  auto kern = wkv6_chunk_kernel<T, TY, K>;
  const size_t smem = Smem<K, T>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(K / block_cols<K>(), p.H, B);  // V = K
  kern<<<grid, THREADS, smem, stream>>>(p);
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

bool aligned16(const void* ptr, long long sb, long long sh, long long st, int elem) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (sb * elem) % 16 == 0 &&
         (sh * elem) % 16 == 0 && (st * elem) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 r, k, v and y; 1 = bfloat16 r, k, v and y; 2 = bfloat16
// r, k, v and float32 y.  log_w, u, s0 and s_out are float32.  Strides in
// elements over (B, H, T) for r, k, v, log_w and y, whose last dim is
// contiguous; u (H, K), s0 and s_out (B, H, K, K) are contiguous, and s_out
// may be s0.  Returns the cudaError_t of the launch (0 on success).
int wkv6_fwd(const void* r, const void* k, const void* v, const void* log_w,
             const void* u, const void* s0, void* y, void* s_out,
             int dtype, int B, int H, int T, int K,
             long long r_sb, long long r_sh, long long r_st,
             long long k_sb, long long k_sh, long long k_st,
             long long v_sb, long long v_sh, long long v_st,
             long long w_sb, long long w_sh, long long w_st,
             long long y_sb, long long y_sh, long long y_st,
             void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || dtype < 0 || dtype > 2) return cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  const bool aligned = aligned16(r, r_sb, r_sh, r_st, elem) &&
                       aligned16(k, k_sb, k_sh, k_st, elem) &&
                       aligned16(v, v_sb, v_sh, v_st, elem) &&
                       aligned16(log_w, w_sb, w_sh, w_st, 4);
  Params p{r, k, v, static_cast<const float*>(log_w), static_cast<const float*>(u),
           static_cast<const float*>(s0), y, static_cast<float*>(s_out), H, T,
           r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
           w_sb, w_sh, w_st, y_sb, y_sh, y_st, aligned};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, float>(p, B, K, s);
  if (dtype == 1) return dispatch<__nv_bfloat16, __nv_bfloat16>(p, B, K, s);
  return dispatch<__nv_bfloat16, float>(p, B, K, s);
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
