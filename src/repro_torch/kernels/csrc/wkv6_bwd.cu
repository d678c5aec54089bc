// The backward pass of the WKV6 recurrence (RWKV-6 "Finch" time mixing)
// for Hopper (sm_90a), in its chunked form, bound to PyTorch with ctypes.
//
// The JAX package has no Pallas backward for `_wkv6_kernel` / `wkv6`
// (src/repro/kernels/rwkv6_wkv.py): XLA differentiates ssm.chunked_scan.
// These kernels are the port's own.  Per (batch, head), with the fp32 state
// S (K x V) of the forward,
//     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(log_w_t),
// and the gradients dy of y and ds_final of the final state, they compute
// dr, dk, dv (in r's dtype), dlog_w, du and ds0 (fp32); the plain version
// is `ref.wkv6_backward_reference`, and `ref.wkv6_backward_chunked_reference`
// mirrors these kernels step for step on the CPU.  r, k, v and dy in f32 or
// bf16; any T >= 1, K = V in {16, 32, 64}; strided (B, H, T, .) views, since
// the model hands in (B, T, H, K) transposed.
//
// What bounds it on the H100: operations.  The gradient needs ~12 fp32
// operations per token and state entry: 6.44 GFLOP at rwkv6-1.6b's training
// shape (B=4, H=32, T=1024, K=V=64), 0.096 ms at 67 TFLOP/s, against
// 205.5 MB of inputs and outputs (0.061 ms at 3.35 TB/s).
//
// What held the first design back: one block per (b, h) walked all 1024
// tokens twice as a chain of dependent fp32 updates (0.61 ms, 6.3x the
// bound).  This design walks chunks of C = 32 tokens instead, and only the
// chunk edges in order.  Per chunk, with cl and cl_prev the inclusive and
// exclusive cumulative sums of log_w, S_in the state before the chunk and
// G_out the state's gradient after it:
//     S_{t-1} = e^{cl_prev_t} . S_in + sum_{j<t} e^{cl_prev_t - cl_j} . k_j v_j^T
//     G_t     = e^{cl_C - cl_t} . G_out + sum_{s>t} e^{cl_prev_s - cl_t} . r_s dy_s^T
// so, with A the forward's matrix (r_t . (u . k_t) on its diagonal) and
// dA = dy v^T:
//     dr = e^{cl_prev} . (dy S_in^T) + intra(dA, k) + u . k (dy . v)
//     dk = e^{cl_C - cl} . (v G_out^T) + intra(dA^T, r) + r . u (dy . v)
//     dv = A^T dy + (k . e^{cl_C - cl}) G_out
// Three launches:
//   1. `wkv6_bwd_sweep_kernel`: the two state sweeps, one launch.  Blocks
//      of the first half walk the chunks forward, S_out = diag(e^{cl_C}) S_in
//      + (k . e^{cl_C - cl})^T v, writing each chunk's S_in to a scratch
//      buffer; blocks of the second half walk backward, G_in = diag(e^{cl_C})
//      G_out + (r . e^{cl_prev})^T dy, writing each G_out, and ds0 = G_in of
//      chunk 0.  A block of 8 warps holds SWEEP_BV = 64 state columns (all of
//      them at K = 64: 2 x 128 blocks, two an SM): 16 or 32 columns made
//      each chunk's operands again in 2 or 4 blocks and took 0.13 / 0.03 ms
//      more (tools/wkv6_bwd_ablation.py).  Each step is one K x C x 64
//      product on `mma.sync`, the state in the accumulators of all 8 warps,
//      with the next chunk staged by `cp.async`.  What bounds the sweeps is
//      their bytes: 134 MB of edges written, k, v, r, dy and log_w (twice)
//      read, ~285 MB.
//   2. `wkv6_bwd_chunk_kernel`: one block per chunk, grid (T/C, H, B).  It
//      stages its chunk (then S_in and G_out in a second `cp.async` group,
//      which lands while the first phases run) in ~112 KB of shared memory
//      (two blocks an SM), forms dA and A's off-diagonal 16 x 16 block on the
//      tensor cores, then A's diagonal blocks and the intra terms of dr and
//      dk on the CUDA cores, then the products with S_in and G_out (each
//      warp 32 tokens by 16 columns, so every operand fragment serves two
//      products).  The intra terms decay per channel: the off-diagonal
//      sub-chunk block is factored about g = cl_prev at the later sub-chunk's
//      start (e^{cl_prev_t - g} e^{g - cl_j}, both exponents <= 0); the
//      diagonal blocks run elementwise with the decay carried as a product of
//      w's down each row (A, dr) and each column (dk).  So no exponent is
//      positive at log_w = -50.
//   3. `wkv6_bwd_carry_kernel`: dlog_w_t = sum_{s>t} Q_s - sum_{j>=t} R_j with
//      Q_t = r_t . (dr_t - u . k_t (dy_t . v_t)) and R_t = k_t . (dk_t -
//      r_t . u (dy_t . v_t)) (Q_T = rowsum(ds_final . S_final)).  The chunk
//      kernel forms Q_{t+1} - R_t per token in fp32 (at log_w = -50 the two
//      cancel to ~0 while their rounding does not) and sums them from the
//      chunk's end; its last token's pair needs the next chunk's Q_0, so it
//      writes its totals, Q_0 and last R.  The carry pass adds to each token
//      the pairs and totals of the later chunks, from the last chunk back, and
//      sums the chunks' du parts in order.
// Every product is 3xTF32 `mma.sync.m16n8k8` (hi and lo each cut to TF32;
// lo.hi + hi.lo + hi.hi in fp32): one TF32 pass misses the fp32 tolerance
// (tests/test_torch_wkv6_bwd_chunked.py).  A bf16 operand is exact in TF32,
// so its lo product is skipped.  cl is formed in one order in every launch
// (sums within parts of 8 tokens, the parts' totals added in order), so cl_C
// and g are bit for bit the cl of their tokens and e^{cl_C - cl} is exactly 1
// at the chunk's last token.  A ragged last chunk is padded with zeros
// (log_w = 0), and T < C is one padded chunk.  No atomics: two calls give
// bit-identical gradients.  The wrapper allocates the scratch
// (wkv6_bwd_scratch_floats: 67 MB of edges each for S and G at the training
// shape).  The design moves ~690 MB at the training shape (the edges
// written and read, log_w read three times, dlog_w read and written by the
// carry): 0.21 ms at 3.35 TB/s, above the function's bound (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int C = 32;          // tokens per chunk
constexpr int SUB = 16;        // tokens per sub-chunk (one mma m-tile)
constexpr int PART = 8;        // tokens per part of a chunk's cumulative sums
constexpr int NPARTS = C / PART;
constexpr int SWEEP_BV = 64;   // state columns per sweep block, at most
constexpr int SWEEP_THREADS = 256;
constexpr int SWEEP_WARPS = SWEEP_THREADS / 32;
constexpr int CHUNK_THREADS = 256;
constexpr int CARRY_THREADS = 256;
constexpr int SLICES = CHUNK_THREADS / C;  // the walks: threads that share a token's channels
constexpr int LDA = C + 4;     // row stride of A and dA (floats)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __host__ __device__ constexpr bool is_bf16() { return std::is_same<T, __nv_bfloat16>::value; }

// Strides in elements over (B, H, T) of each strided tensor, in this order.
enum { R_, K_, V_, W_, DY_, DR_, DK_, DV_, DW_, N_STRIDED };
// A chunk's summaries in Params::sums, each (B, H, n_chunks, K): its tokens'
// dlog_w before the carry at its first token, Q of its first token, R of its
// last, its part of du.
enum { SUM_P, SUM_Q, SUM_R, SUM_DU, N_SUMS };

struct Params {
  const void* r; const void* k; const void* v; const float* lw; const float* u;
  const float* s0; const void* dy; const float* ds;  // ds may be null (zero)
  void* dr; void* dk; void* dv; float* dlw; float* du_part; float* ds0;
  float* s_edge;  // (B, H, n_chunks, K, V): S_in of each chunk
  float* g_edge;  // (B, H, n_chunks, K, V): G_out of each chunk
  float* sums;    // (N_SUMS, B, H, n_chunks, K)
  float* q_last;  // (B, H, SweepShape<K>::QP, K): Q_T over each sweep warp's columns
  int B, H, T, n_chunks;
  long long st[N_STRIDED][3];
  bool aligned;   // every staged row starts on 16 bytes: cp.async may copy it
};

// How a sweep block holds its state columns: warp w takes m-tile (16 rows)
// w % MT and n-tiles (8 columns) NTW (w / MT) .. of the block's BV columns.
template <int K>
struct SweepShape {
  static constexpr int BV = K < SWEEP_BV ? K : SWEEP_BV;
  static constexpr int NVS = K / BV;                  // column slices: blocks per direction
  static constexpr int MT = K / 16, NTB = BV / 8;     // m-tiles, n-tiles of a block
  static constexpr int NTW = NTB * MT > SWEEP_WARPS ? NTB * MT / SWEEP_WARPS : 1;  // n-tiles a warp
  static constexpr int GROUPS = NTB / NTW;            // warps that share an m-tile
  static constexpr int QP = NVS * GROUPS;             // parts of each row of Q_T
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

// Every committed group but the last has landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// x = hi + lo to ~21 mantissa bits: hi is x cut to TF32's 10 mantissa bits
// (so x - hi is exact in fp32), and the tensor cores read lo cut the same
// way.  Two instructions, where rounding each part (cvt.rna.tf32.f32) took
// five and 8% more time (tools/wkv6_bwd_ablation.py, PERF.md).  An x that
// is exact in TF32 (a bf16 value) is its own hi.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
  } else {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32): lane = 4 g + t.  a holds
// (row, col) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b holds
// (k, n) = (t, g), (t + 4, g); the accumulator c holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
//
// c[m][n] += A_m hi.B_n hi and cl[m][n] += A_m lo.B_n hi + A_m hi.B_n lo
// over one k-step of 8 (3xTF32; the caller adds cl to c), for MT m-tiles
// and NT n-tiles: each A fragment is split once for every n-tile and each B
// fragment once for every m-tile.  A(row, col) is a[row * ars + col * acs]
// (m-tile m: rows 16 m ..) and B_n(k, col) is b[k * bks + (8 n + col) *
// bns] (the strides let one helper read a matrix or its transpose).
// A_EXACT / B_EXACT: that operand is exact in TF32, so its lo part is zero
// and that product is skipped.
template <int MT, int NT, bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[MT][NT][4], float (&cl)[MT][NT][4], const float* a,
                                     int ars, int acs, const float* b, int bks, int bns, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float* am = a + 16 * m * ars;
    split<A_EXACT>(am[g * ars + t * acs], ah[m][0], al[m][0]);
    split<A_EXACT>(am[(g + 8) * ars + t * acs], ah[m][1], al[m][1]);
    split<A_EXACT>(am[g * ars + (t + 4) * acs], ah[m][2], al[m][2]);
    split<A_EXACT>(am[(g + 8) * ars + (t + 4) * acs], ah[m][3], al[m][3]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float* bn = b + 8 * n * bns;
    split<B_EXACT>(bn[t * bks + g * bns], bh[n][0], bl[n][0]);
    split<B_EXACT>(bn[(t + 4) * bks + g * bns], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (!A_EXACT) mma_tf32(cl[m][n], al[m], bh[n][0], bh[n][1]);
      if (!B_EXACT) mma_tf32(cl[m][n], ah[m], bl[n][0], bl[n][1]);
      mma_tf32(c[m][n], ah[m], bh[n][0], bh[n][1]);
    }
}

// The same, every product into c: one accumulator a tile.
template <int MT, int NT, bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&c)[MT][NT][4], const float* a, int ars, int acs,
                                     const float* b, int bks, int bns, int lane) {
  mma3<MT, NT, A_EXACT, B_EXACT>(c, c, a, ars, acs, b, bks, bns, lane);
}

// Stage rows t0 .. t0 + C - 1 (COLS elements each, `st` apart in src, `ld`
// apart in dst) into shared memory, zeros past T: 16-byte cp.async pieces
// when aligned, else plain loads.
template <typename E, int COLS, int THREADS>
__device__ __forceinline__ void stage(E* dst, int ld, const E* src, long long st, int t0,
                                      int T, bool aligned, int tid) {
  if (aligned) {
    constexpr int PER = 16 / sizeof(E), PIECES = COLS / PER;
    for (int i = tid; i < C * PIECES; i += THREADS) {
      const int row = i / PIECES, pc = i % PIECES;
      const bool ok = t0 + row < T;
      cp_async16(dst + row * ld + pc * PER,
                 ok ? src + (long long)(t0 + row) * st + pc * PER : src, ok);
    }
  } else {
    for (int i = tid; i < C * COLS; i += THREADS) {
      const int row = i / COLS, col = i % COLS;
      dst[row * ld + col] =
          t0 + row < T ? src[(long long)(t0 + row) * st + col] : from_float<E>(0.f);
    }
  }
}

// N consecutive values x into dst as T: one store of N values when dst is
// aligned to them (N sizeof(T) = 4 .. 16 bytes, or 32 for fp32 in two),
// else one at a time.
template <typename T, int N>
__device__ __forceinline__ void st_global(T* dst, const float (&x)[N]) {
  constexpr int BYTES = N * sizeof(T) > 16 ? 16 : N * sizeof(T);
  using V = typename std::conditional<BYTES == 16, uint4,
            typename std::conditional<BYTES == 8, uint2, uint32_t>::type>::type;
  if (reinterpret_cast<uintptr_t>(dst) % BYTES == 0) {
    constexpr int PER = BYTES / sizeof(T);
#pragma unroll
    for (int i = 0; i < N; i += PER) {
      V v;
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < PER; ++j) e[j] = from_float<T>(x[i + j]);
      *reinterpret_cast<V*>(dst + i) = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = from_float<T>(x[i]);
  }
}

// N consecutive floats from shared memory (N = 2 or a multiple of 4, aligned).
template <int N>
__device__ __forceinline__ void ld_smem(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      x[i] = t.x; x[i + 1] = t.y; x[i + 2] = t.z; x[i + 3] = t.w;
    }
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  }
}

// ---------------------------------------------------------------------------
// 1. the two state sweeps
// ---------------------------------------------------------------------------

template <int K>
struct SweepSmem {  // in floats; every array starts on 16 bytes
  static constexpr int BV = SweepShape<K>::BV;
  static constexpr int LDX = K + 8;   // the scaled k or r, read transposed: conflict-free
  static constexpr int LDC = BV + 8;  // v or dy
  static constexpr int XD = 0;                    // k . e^{cl_C - cl} or r . e^{cl_prev} (C, K)
  static constexpr int CS = XD + C * LDX;         // v or dy, fp32 (C, BV)
  static constexpr int PS = CS + C * LDC;         // log_w summed over each part (NPARTS, K)
  static constexpr int DK = PS + NPARTS * K;      // e^{cl_C} (K)
  static constexpr int STAGE = DK + K;            // two stages, each:
  static constexpr int TW = 0;                    //   log_w (C, K)
  static constexpr int TX = TW + C * K;           //   k or r (C, K), room for fp32
  static constexpr int TC = TX + C * K;           //   v or dy (C, BV), room for fp32
  static constexpr int STAGE_FLOATS = TC + C * BV;
  static constexpr int FLOATS = STAGE + 2 * STAGE_FLOATS;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// One sweep over the V columns j0 .. j0 + BV - 1.  FWD: S from s0, chunks
// forward, each S_in to s_edge, then this block's part of Q_T.  Else: G from
// ds_final, chunks backward, each G_out to g_edge, then ds0.  TX: the type of
// k or r; TC: of v or dy.  The chunk two steps ahead is in flight while a
// step runs.
template <typename TX, typename TC, int K, bool FWD>
__device__ __forceinline__ void sweep(const Params& p, float* sm, int vs) {
  using L = SweepSmem<K>;
  using SH = SweepShape<K>;
  constexpr int BV = SH::BV, NTW = SH::NTW, MT = SH::MT, LDX = L::LDX, LDC = L::LDC;
  float* Xd = sm + L::XD;  float* Cs = sm + L::CS;  float* Ps = sm + L::PS;
  float* Dk = sm + L::DK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, j0 = vs * BV;
  const int XI = FWD ? K_ : R_, CI = FWD ? V_ : DY_;
  const TX* xb = static_cast<const TX*>(FWD ? p.k : p.r) + b * p.st[XI][0] + h * p.st[XI][1];
  const TC* cb = static_cast<const TC*>(FWD ? p.v : p.dy) + b * p.st[CI][0] + h * p.st[CI][1] + j0;
  const float* wb = p.lw + b * p.st[W_][0] + h * p.st[W_][1];
  const long long bh = (long long)b * p.H + h;
  const int nc = p.n_chunks;
  // the warp's part of the state, in the accumulator layout: rows `row` and
  // row + 8, columns jw + 8 n + 2 tq, +1 for n < NTW
  const int mt = warp % MT, grp = warp / MT;
  const bool mine = grp < SH::GROUPS;
  const int row = 16 * mt + g, jw = j0 + 8 * NTW * grp;
  float S[1][NTW][4];
  const float* init = FWD ? p.s0 : p.ds;
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      S[0][n][e] = mine && init ? init[bh * K * K + (row + (e >> 1) * 8) * K + jw + 8 * n + 2 * tq + (e & 1)]
                                : 0.f;

  auto stage_at = [&](int i) { return sm + L::STAGE + (i & 1) * L::STAGE_FLOATS; };
  auto fetch = [&](int i) {  // step i's chunk into stage i % 2; an empty group past the end
    if (i < nc) {
      const int c = FWD ? i : nc - 1 - i;
      float* st = stage_at(i);
      stage<TX, K, SWEEP_THREADS>(reinterpret_cast<TX*>(st + L::TX), K, xb, p.st[XI][2], c * C,
                                  p.T, p.aligned, tid);
      stage<float, K, SWEEP_THREADS>(st + L::TW, K, wb, p.st[W_][2], c * C, p.T, p.aligned, tid);
      stage<TC, BV, SWEEP_THREADS>(reinterpret_cast<TC*>(st + L::TC), BV, cb, p.st[CI][2], c * C,
                                   p.T, p.aligned, tid);
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);
  for (int i = 0; i < nc; ++i) {
    const int c = FWD ? i : nc - 1 - i;
    const float* Tw = stage_at(i) + L::TW;
    const TX* Tx = reinterpret_cast<const TX*>(stage_at(i) + L::TX);
    const TC* Tc = reinterpret_cast<const TC*>(stage_at(i) + L::TC);
    if (mine) {  // the edge: S before chunk c, or G after it
      float* e = (FWD ? p.s_edge : p.g_edge) + (bh * nc + c) * K * K + (long long)row * K + jw + 2 * tq;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        *reinterpret_cast<float2*>(e + 8 * n) = make_float2(S[0][n][0], S[0][n][1]);
        *reinterpret_cast<float2*>(e + 8 * K + 8 * n) = make_float2(S[0][n][2], S[0][n][3]);
      }
    }
    cp_async_wait_prior();
    __syncthreads();  // step i's chunk is staged; the last step is done with Xd, Cs and Dk
    for (int x = tid; x < NPARTS * K; x += SWEEP_THREADS) {
      const int part = x / K, kk = x % K;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < PART; ++j) s += Tw[(part * PART + j) * K + kk];
      Ps[x] = s;
    }
    for (int x = tid; x < C * BV; x += SWEEP_THREADS) Cs[(x / BV) * LDC + x % BV] = to_float(Tc[x]);
    __syncthreads();
    for (int x = tid; x < NPARTS * K; x += SWEEP_THREADS) {
      // cl of the part's tokens: the earlier parts' totals added in order,
      // then the sum within the part (the chunk kernel's order)
      const int part = x / K, kk = x % K;
      float pre = 0.f, total = 0.f;
#pragma unroll
      for (int j = 0; j < NPARTS; ++j) {
        if (j == part) pre = total;
        total += Ps[j * K + kk];
      }
      float inner = 0.f, clp = pre;
#pragma unroll
      for (int j = 0; j < PART; ++j) {
        const int tt = part * PART + j;
        inner += Tw[tt * K + kk];
        const float cl = pre + inner;
        const float xv = to_float(Tx[tt * K + kk]);
        Xd[tt * LDX + kk] = FWD ? xv * __expf(total - cl) : xv * __expf(clp);
        clp = cl;
      }
      if (part == 0) Dk[kk] = __expf(total);
    }
    __syncthreads();  // Xd, Cs and Dk are ready; this stage is free
    fetch(i + 2);
    if (mine) {  // S = diag(e^{cl_C}) S + Xd^T Cs
      const float d0 = Dk[row], d8 = Dk[row + 8];
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        S[0][n][0] *= d0; S[0][n][1] *= d0; S[0][n][2] *= d8; S[0][n][3] *= d8;
      }
      float Sl[1][NTW][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 8)
        mma3<1, NTW, false, is_bf16<TC>()>(S, Sl, Xd + k0 * LDX + 16 * mt, 1, LDX,
                                           Cs + k0 * LDC + (jw - j0), LDC, 1, lane);
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[0][n][e] += Sl[0][n][e];
    }
  }
  cp_async_wait_all();
  if (!mine) return;
  if (FWD) {  // Q_T over this block's columns: rowsum(ds_final . S_final)
    float q0 = 0.f, q8 = 0.f;
    if (p.ds != nullptr) {
      const float* d = p.ds + bh * K * K + (long long)row * K + jw + 2 * tq;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        q0 = fmaf(d[8 * n], S[0][n][0], q0);
        q0 = fmaf(d[8 * n + 1], S[0][n][1], q0);
        q8 = fmaf(d[8 * K + 8 * n], S[0][n][2], q8);
        q8 = fmaf(d[8 * K + 8 * n + 1], S[0][n][3], q8);
      }
    }
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      q0 += __shfl_xor_sync(FULL, q0, m);
      q8 += __shfl_xor_sync(FULL, q8, m);
    }
    if (tq == 0) {
      float* q = p.q_last + (bh * SH::QP + vs * SH::GROUPS + grp) * K + row;
      q[0] = q0;
      q[8] = q8;
    }
  } else {  // ds0 = G_in of chunk 0
    float* e = p.ds0 + bh * K * K + (long long)row * K + jw + 2 * tq;
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      *reinterpret_cast<float2*>(e + 8 * n) = make_float2(S[0][n][0], S[0][n][1]);
      *reinterpret_cast<float2*>(e + 8 * K + 8 * n) = make_float2(S[0][n][2], S[0][n][3]);
    }
  }
}

// T: the type of r, k and v; TD: the type of dy.  Grid (2 K / SWEEP_BV, H,
// B): the first half of blockIdx.x sweeps forward, the second backward.
template <typename T, typename TD, int K>
__global__ void __launch_bounds__(SWEEP_THREADS, 2)
wkv6_bwd_sweep_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];
  constexpr int NVS = SweepShape<K>::NVS;
  if ((int)blockIdx.x < NVS)
    sweep<T, T, K, true>(p, sm, blockIdx.x);
  else
    sweep<T, TD, K, false>(p, sm, blockIdx.x - NVS);
}

// ---------------------------------------------------------------------------
// 2. the chunks, in parallel
// ---------------------------------------------------------------------------

template <int K>
struct ChunkSmem {  // in floats; every array starts on 16 bytes
  static constexpr int LDK = K + 4;  // by token (r, k, v, dy, w, CL, ..) and by state row
  static constexpr int ROWS = K > C ? K : C;      // of S_in's and G_out's rooms
  static constexpr int SS = 0;                    // S_in (K, V); then dr's products, then Q (C, K)
  static constexpr int GS = SS + ROWS * LDK;      // G_out (K, V); then dk's products, then R
  static constexpr int RS = GS + ROWS * LDK;      // r (C, K)
  static constexpr int KS = RS + C * LDK;         // k
  static constexpr int VS = KS + C * LDK;         // v (C, V)
  static constexpr int DS = VS + C * LDK;         // dy
  static constexpr int WS = DS + C * LDK;         // log_w, then w = e^{log_w}
  static constexpr int CL = WS + C * LDK;         // (C + 1, K): cl_prev_t = CL[t], cl_t = CL[t + 1]
  static constexpr int KD = CL + (C + 1) * LDK;   // k . e^{cl_C - cl} (C, K); first the staged bf16
                                                  // inputs, last the part sums of the scan
  static constexpr int RQ = KD + C * LDK;         // r . e^{cl_prev - g}, later sub-chunk (SUB, K)
  static constexpr int KQ = RQ + SUB * LDK;       // k . e^{g - cl}, earlier sub-chunk (SUB, K)
  static constexpr int AS = KQ + SUB * LDK;       // A (C, C)
  static constexpr int DA = AS + C * LDA;         // dA = dy v^T (C, C); first the part sums of log_w
  static constexpr int US = DA + C * LDA;         // u (K)
  static constexpr int FLOATS = US + K;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename T, typename TD, int K>
__global__ void __launch_bounds__(CHUNK_THREADS, 2)
wkv6_bwd_chunk_kernel(const Params p) {
  using L = ChunkSmem<K>;
  constexpr int LDK = L::LDK, KSL = K / SLICES;  // the walks: channels of a thread
  constexpr bool T_BF = is_bf16<T>(), TD_BF = is_bf16<TD>();
  static_assert(NPARTS * K <= CHUNK_THREADS && C % PART == 0 && SUB % 4 == 0,
                "a thread per (part, channel) and four rows of a sub-chunk per warp");
  extern __shared__ __align__(16) float sm[];
  float* Ss = sm + L::SS;  float* Gs = sm + L::GS;  float* Rs = sm + L::RS;
  float* Ks = sm + L::KS;  float* Vs = sm + L::VS;  float* Ds = sm + L::DS;
  float* Ws = sm + L::WS;  float* CLs = sm + L::CL;  float* Kd = sm + L::KD;
  float* Rq = sm + L::RQ;  float* Kq = sm + L::KQ;  float* As = sm + L::AS;
  float* dAs = sm + L::DA;  float* Us = sm + L::US;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, t0 = c * C;
  const int n_tok = min(C, p.T - t0);  // the chunk's tokens
  const long long bh = (long long)b * p.H + h;
  auto at = [&](int which) { return b * p.st[which][0] + h * p.st[which][1]; };
  const T* rb = static_cast<const T*>(p.r) + at(R_);
  const T* kb = static_cast<const T*>(p.k) + at(K_);
  const T* vb = static_cast<const T*>(p.v) + at(V_);
  const TD* db = static_cast<const TD*>(p.dy) + at(DY_);
  const float* wb = p.lw + at(W_);

  // ---- stage the chunk, S_in and G_out; bf16 inputs into Kd's room ----
  T* Tr = reinterpret_cast<T*>(Kd);
  T* Tk = Tr + C * K;
  T* Tv = Tk + C * K;
  TD* Td = reinterpret_cast<TD*>(T_BF ? reinterpret_cast<char*>(Tv + C * K)
                                      : reinterpret_cast<char*>(Kd));
  if constexpr (T_BF) {
    stage<T, K, CHUNK_THREADS>(Tr, K, rb, p.st[R_][2], t0, p.T, p.aligned, tid);
    stage<T, K, CHUNK_THREADS>(Tk, K, kb, p.st[K_][2], t0, p.T, p.aligned, tid);
    stage<T, K, CHUNK_THREADS>(Tv, K, vb, p.st[V_][2], t0, p.T, p.aligned, tid);
  } else {
    stage<T, K, CHUNK_THREADS>(Rs, LDK, rb, p.st[R_][2], t0, p.T, p.aligned, tid);
    stage<T, K, CHUNK_THREADS>(Ks, LDK, kb, p.st[K_][2], t0, p.T, p.aligned, tid);
    stage<T, K, CHUNK_THREADS>(Vs, LDK, vb, p.st[V_][2], t0, p.T, p.aligned, tid);
  }
  if constexpr (TD_BF)
    stage<TD, K, CHUNK_THREADS>(Td, K, db, p.st[DY_][2], t0, p.T, p.aligned, tid);
  else
    stage<TD, K, CHUNK_THREADS>(Ds, LDK, db, p.st[DY_][2], t0, p.T, p.aligned, tid);
  stage<float, K, CHUNK_THREADS>(Ws, LDK, wb, p.st[W_][2], t0, p.T, p.aligned, tid);
  cp_async_commit();
  {  // S_in and G_out: a second group, which lands while the operands, dA and the walks run
    const float* se = p.s_edge + (bh * p.n_chunks + c) * K * K;
    const float* ge = p.g_edge + (bh * p.n_chunks + c) * K * K;
    for (int i = tid; i < K * K / 4; i += CHUNK_THREADS) {
      const int row = i / (K / 4), col = 4 * (i % (K / 4));
      cp_async16(Ss + row * LDK + col, se + 4 * i, true);
      cp_async16(Gs + row * LDK + col, ge + 4 * i, true);
    }
  }
  cp_async_commit();
  for (int i = tid; i < C * LDA; i += CHUNK_THREADS) As[i] = 0.f;  // A's upper triangle stays 0
  for (int i = tid; i < K; i += CHUNK_THREADS) Us[i] = p.u[h * K + i];
  cp_async_wait_prior();
  __syncthreads();

  // ---- fp32 operands; a thread per (part, channel) ----
  const bool pt = tid < NPARTS * K;
  const int part = tid / K, pk = tid % K;
  if (pt) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < PART; ++j) {
      const int tt = part * PART + j;
      if constexpr (T_BF) {
        Rs[tt * LDK + pk] = to_float(Tr[tt * K + pk]);
        Ks[tt * LDK + pk] = to_float(Tk[tt * K + pk]);
        Vs[tt * LDK + pk] = to_float(Tv[tt * K + pk]);
      }
      if constexpr (TD_BF) Ds[tt * LDK + pk] = to_float(Td[tt * K + pk]);
      s += Ws[tt * LDK + pk];
    }
    dAs[tid] = s;  // the part's sum of log_w, in dA's room
  }
  __syncthreads();
  if (pt) {  // cl in the sweeps' order; g = cl_prev at SUB, cl_C = CL[C]
    float pre = 0.f, gref = 0.f, total = 0.f;
#pragma unroll
    for (int j = 0; j < NPARTS; ++j) {
      if (j == part) pre = total;
      if (j == SUB / PART) gref = total;
      total += dAs[j * K + pk];
    }
    if (part == 0) CLs[pk] = 0.f;
    float inner = 0.f, clp = pre;
#pragma unroll
    for (int j = 0; j < PART; ++j) {
      const int tt = part * PART + j;
      const float lw = Ws[tt * LDK + pk];
      inner += lw;
      const float cl = pre + inner, kv = Ks[tt * LDK + pk];
      CLs[(tt + 1) * LDK + pk] = cl;
      Ws[tt * LDK + pk] = __expf(lw);
      Kd[tt * LDK + pk] = kv * __expf(total - cl);
      if (tt < SUB)
        Kq[tt * LDK + pk] = kv * __expf(gref - cl);
      else
        Rq[(tt - SUB) * LDK + pk] = Rs[tt * LDK + pk] * __expf(clp - gref);
      clp = cl;
    }
  }
  __syncthreads();

  // ---- dA = dy v^T (its lower tiles) and A's off-diagonal block ----
  if (warp < 6) {  // dA tiles (m, n) = (0, 0), (0, 1), (1, 0) .. (1, 3)
    const int m = warp < 2 ? 0 : 1, nt = warp < 2 ? warp : warp - 2;
    float acc[1][1][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8)
      mma3<1, 1, TD_BF, T_BF>(acc, Ds + 16 * m * LDK + k0, LDK, 1, Vs + 8 * nt * LDK + k0, 1, LDK,
                              lane);
    float* a = dAs + (16 * m + g) * LDA + 8 * nt + 2 * tq;
    a[0] = acc[0][0][0]; a[1] = acc[0][0][1]; a[8 * LDA] = acc[0][0][2]; a[8 * LDA + 1] = acc[0][0][3];
  } else {  // (r . e^{cl_prev - g}) (k . e^{g - cl})^T, columns 8 (warp - 6) ..
    const int nt = warp - 6;
    float acc[1][1][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 8)
      mma3<1, 1, false, false>(acc, Rq + k0, LDK, 1, Kq + 8 * nt * LDK + k0, 1, LDK, lane);
    float* a = As + (SUB + g) * LDA + 8 * nt + 2 * tq;
    a[0] = acc[0][0][0]; a[1] = acc[0][0][1]; a[8 * LDA] = acc[0][0][2]; a[8 * LDA + 1] = acc[0][0][3];
  }
  __syncthreads();

  // ---- the diagonal blocks on the CUDA cores: thread (token wt, slice) ----
  // Row wt: A[wt][j] = sum_k r_wt k_j D and dr's intra term sum_j dA[wt][j]
  // k_j D, with D = e^{cl_prev_wt - cl_j} = w_{wt-1} .. w_{j+1} carried down
  // the row; column wt: dk's intra term sum_s dA[s][wt] r_s D, with D =
  // w_{wt+1} .. w_{s-1} carried down the column.  Row and column of one token
  // take SUB - 1 steps together.  A's row sums go over the slices by shuffles.
  const int wt = tid / SLICES, kk0 = (tid % SLICES) * KSL, ts = wt % SUB;
  float accR[KSL] = {}, accK[KSL] = {};  // dr's and dk's intra terms of token wt
  {
    float r[KSL], kt[KSL], uu[KSL], d[KSL], acc[SUB - 1] = {}, bonus = 0.f;
    ld_smem<KSL>(r, Rs + wt * LDK + kk0);
    ld_smem<KSL>(kt, Ks + wt * LDK + kk0);
    ld_smem<KSL>(uu, Us + kk0);
#pragma unroll
    for (int x = 0; x < KSL; ++x) {
      bonus = fmaf(r[x] * uu[x], kt[x], bonus);
      d[x] = 1.f;
    }
    const int rows = ts | 3;  // the longest row of the warp's four
#pragma unroll
    for (int e = 0; e < SUB - 1; ++e) {
      if (e >= rows) break;  // uniform in the warp
      if (e < ts) {
        const int j = wt - 1 - e;
        const float a = dAs[wt * LDA + j];
        float kj[KSL], wj[KSL];
        ld_smem<KSL>(kj, Ks + j * LDK + kk0);
        ld_smem<KSL>(wj, Ws + j * LDK + kk0);
#pragma unroll
        for (int x = 0; x < KSL; ++x) {
          const float kd = kj[x] * d[x];
          acc[e] = fmaf(r[x], kd, acc[e]);
          accR[x] = fmaf(a, kd, accR[x]);
          d[x] *= wj[x];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < SUB - 1; ++e) {
      if (e >= rows) break;
#pragma unroll
      for (int m = 1; m < SLICES; m <<= 1) acc[e] += __shfl_xor_sync(FULL, acc[e], m);
    }
#pragma unroll
    for (int m = 1; m < SLICES; m <<= 1) bonus += __shfl_xor_sync(FULL, bonus, m);
    if (kk0 == 0) {
#pragma unroll
      for (int e = 0; e < SUB - 1; ++e)
        if (e < ts) As[wt * LDA + wt - 1 - e] = acc[e];
      As[wt * LDA + wt] = bonus;
    }
#pragma unroll
    for (int x = 0; x < KSL; ++x) d[x] = 1.f;
    const int len = SUB - 1 - ts, cols = SUB - 1 - (ts & ~3);  // cols: the longest of the warp
#pragma unroll
    for (int e = 0; e < SUB - 1; ++e) {
      if (e >= cols) break;
      if (e < len) {
        const int s = wt + 1 + e;
        const float a = dAs[s * LDA + wt];
        float rs[KSL], ws[KSL];
        ld_smem<KSL>(rs, Rs + s * LDK + kk0);
        ld_smem<KSL>(ws, Ws + s * LDK + kk0);
#pragma unroll
        for (int x = 0; x < KSL; ++x) {
          accK[x] = fmaf(a, rs[x] * d[x], accK[x]);
          d[x] *= ws[x];
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // A is complete; S_in and G_out have landed

  // ---- the products with S_in and G_out.  Warp w takes columns 16 (w % 4)
  // .. of all 32 tokens (two m-tiles, two n-tiles, so every fragment serves
  // two products): warps 0-3 dr's and dk's, warps 4-7 dv ----
  constexpr int NQ = K / 16;  // column blocks of 16
  const bool prod = warp % 4 < NQ;
  const int n0 = 16 * (warp % 4);
  if (warp < 4) {
    float X[2][2][4] = {}, Z[2][2][4] = {}, Y[1][2][4] = {}, W[1][2][4] = {};
    if (prod) {
#pragma unroll 2
      for (int k0 = 0; k0 < K; k0 += 8) {  // dy S_in^T and v G_out^T: (C, V) (V, K)
        mma3<2, 2, TD_BF, false>(X, Ds + k0, LDK, 1, Ss + n0 * LDK + k0, 1, LDK, lane);
        mma3<2, 2, T_BF, false>(Z, Vs + k0, LDK, 1, Gs + n0 * LDK + k0, 1, LDK, lane);
      }
#pragma unroll
      for (int k0 = 0; k0 < SUB; k0 += 8) {
        // the later sub-chunk's rows of dr: dA_off (k . e^{g - cl});
        // the earlier's of dk: dA_off^T (r . e^{cl_prev - g})
        mma3<1, 2, false, false>(Y, dAs + SUB * LDA + k0, LDA, 1, Kq + k0 * LDK + n0, LDK, 1, lane);
        mma3<1, 2, false, false>(W, dAs + (SUB + k0) * LDA, 1, LDA, Rq + k0 * LDK + n0, LDK, 1, lane);
      }
    }
    __syncthreads();  // every read of S_in, G_out, Kq and Rq is done
    if (prod) {  // dr and dk but for their intra and bonus terms, into S_in's and G_out's rooms
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = 16 * m + g + (e >> 1) * 8, col = n0 + 8 * n + 2 * tq + (e & 1);
            const float clp = CLs[t * LDK + col], cl = CLs[(t + 1) * LDK + col];
            const float total = CLs[C * LDK + col], gref = CLs[SUB * LDK + col];
            float xr = __expf(clp) * X[m][n][e], xk = __expf(total - cl) * Z[m][n][e];
            if (m == 1) xr = fmaf(__expf(clp - gref), Y[0][n][e], xr);
            if (m == 0) xk = fmaf(__expf(gref - cl), W[0][n][e], xk);
            Ss[t * LDK + col] = xr;
            Gs[t * LDK + col] = xk;
          }
    }
  } else {
    float DV[2][2][4] = {};
    if (prod) {
#pragma unroll 2
      for (int k0 = 0; k0 < K; k0 += 8)  // (k . e^{cl_C - cl}) G_out: (C, K) (K, V)
        mma3<2, 2, false, false>(DV, Kd + k0, LDK, 1, Gs + k0 * LDK + n0, LDK, 1, lane);
      // A^T dy over the tokens from each m-tile's first (A is lower triangular)
      float (&DV0)[1][2][4] = *reinterpret_cast<float (*)[1][2][4]>(&DV[0]);
#pragma unroll
      for (int k0 = 0; k0 < SUB; k0 += 8)
        mma3<1, 2, false, TD_BF>(DV0, As + k0 * LDA, 1, LDA, Ds + k0 * LDK + n0, LDK, 1, lane);
#pragma unroll
      for (int k0 = SUB; k0 < C; k0 += 8)
        mma3<2, 2, false, TD_BF>(DV, As + k0 * LDA, 1, LDA, Ds + k0 * LDK + n0, LDK, 1, lane);
    }
    __syncthreads();  // the same barrier as warps 0-3's: every read of G_out is done
    if (prod) {
      T* dvb = static_cast<T*>(p.dv) + at(DV_);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int t = 16 * m + g + (e >> 1) * 8;
            const float pair[2] = {DV[m][n][e], DV[m][n][e + 1]};
            if (t < n_tok)
              st_global<T, 2>(dvb + (long long)(t0 + t) * p.st[DV_][2] + n0 + 8 * n + 2 * tq, pair);
          }
    }
  }
  __syncthreads();

  // ---- dr, dk, and Q, R in their place: thread (token wt, slice) again ----
  {
    float r[KSL], kt[KSL], uu[KSL], xr[KSL], xk[KSL], dr[KSL], dk[KSL];
    ld_smem<KSL>(r, Rs + wt * LDK + kk0);
    ld_smem<KSL>(kt, Ks + wt * LDK + kk0);
    ld_smem<KSL>(uu, Us + kk0);
    ld_smem<KSL>(xr, Ss + wt * LDK + kk0);
    ld_smem<KSL>(xk, Gs + wt * LDK + kk0);
    const float dyv = dAs[wt * LDA + wt];
#pragma unroll
    for (int x = 0; x < KSL; ++x) {
      xr[x] += accR[x];
      xk[x] += accK[x];
      dr[x] = fmaf(uu[x] * kt[x], dyv, xr[x]);
      dk[x] = fmaf(r[x] * uu[x], dyv, xk[x]);
      Ss[wt * LDK + kk0 + x] = r[x] * xr[x];   // Q
      Gs[wt * LDK + kk0 + x] = kt[x] * xk[x];  // R
    }
    if (wt < n_tok) {
      st_global<T, KSL>(static_cast<T*>(p.dr) + at(DR_) + (long long)(t0 + wt) * p.st[DR_][2] + kk0, dr);
      st_global<T, KSL>(static_cast<T*>(p.dk) + at(DK_) + (long long)(t0 + wt) * p.st[DK_][2] + kk0, dk);
    }
  }
  __syncthreads();

  // ---- dlog_w within the chunk: Q_{t+1} - R_t summed from each part's end,
  // then the later parts' totals; the chunk's summaries ----
  float* Ps = Kd;              // part totals (NPARTS, K)
  float* Pu = Kd + NPARTS * K;  // parts of du (NPARTS, K)
  float loc[PART];
  if (pt) {
    float acc = 0.f, du = 0.f;
#pragma unroll
    for (int j = PART - 1; j >= 0; --j) {
      const int tt = part * PART + j;
      if (tt < n_tok - 1) acc += Ss[(tt + 1) * LDK + pk] - Gs[tt * LDK + pk];
      loc[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < PART; ++j) {
      const int tt = part * PART + j;
      du = fmaf(Rs[tt * LDK + pk] * Ks[tt * LDK + pk], dAs[tt * LDA + tt], du);
    }
    Ps[tid] = acc;
    Pu[tid] = du;
  }
  __syncthreads();
  if (pt) {
    float later = 0.f;
#pragma unroll
    for (int j = NPARTS - 1; j > 0; --j)
      if (j > part) later += Ps[j * K + pk];
    float* dwb = p.dlw + at(DW_);
#pragma unroll
    for (int j = 0; j < PART; ++j) {
      const int tt = part * PART + j;
      if (tt < n_tok) dwb[(long long)(t0 + tt) * p.st[DW_][2] + pk] = loc[j] + later;
    }
    if (part == 0) {
      float du = 0.f;
#pragma unroll
      for (int j = 0; j < NPARTS; ++j) du += Pu[j * K + pk];
      float* s = p.sums + (bh * p.n_chunks + c) * K + pk;
      const long long plane = (long long)p.B * p.H * p.n_chunks * K;
      s[SUM_P * plane] = loc[0] + later;
      s[SUM_Q * plane] = Ss[pk];
      s[SUM_R * plane] = Gs[(n_tok - 1) * LDK + pk];
      s[SUM_DU * plane] = du;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the carry of dlog_w across chunks, and du
// ---------------------------------------------------------------------------

constexpr int CARRY_SEG = 32;    // chunks whose summaries the carry stages at a time
constexpr int CARRY_CHUNKS = 8;  // chunks a carry block adds its carries to

// Grid (n_chunks / CARRY_CHUNKS, H, B).  A block forms the carries of its
// chunks from the later chunks' summaries, from the last chunk back in one
// order in every block: carry_{last} = Q_T - R_last, carry_c = (Q_0 of c + 1
// - R_last of c) + (total of c + 1 + carry_{c+1}); the summaries come into
// shared memory CARRY_SEG chunks at a time, all loads in flight together.
// Then it adds each chunk's carry to its tokens' dlog_w.  Block 0 also sums
// the chunks' du parts.
template <int K>
__global__ void __launch_bounds__(CARRY_THREADS)
wkv6_bwd_carry_kernel(const Params p) {
  extern __shared__ __align__(16) float sm[];  // carries (CARRY_CHUNKS, K), then summaries (3, CARRY_SEG, K)
  constexpr int QP = SweepShape<K>::QP;
  float* seg = sm + CARRY_CHUNKS * K;
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x, nc = p.n_chunks;
  const int c_lo = blockIdx.x * CARRY_CHUNKS, c_hi = min(nc, c_lo + CARRY_CHUNKS) - 1;
  const long long bh = (long long)b * p.H + h, plane = (long long)p.B * p.H * nc * K;
  const float* sums = p.sums + bh * nc * K;
  float run = 0.f;
  if (tid < K) {
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < QP; ++i) q += p.q_last[(bh * QP + i) * K + tid];
    run = q - sums[SUM_R * plane + (long long)(nc - 1) * K + tid];
    if (c_hi == nc - 1) sm[(c_hi - c_lo) * K + tid] = run;
  }
  // chunks cc = nc - 2 .. c_lo take a step each, from the last; a segment
  // holds the summaries of chunks lo .. hi (their R, the next chunk's Q and
  // total)
  for (int hi = nc - 2; hi >= c_lo; hi -= CARRY_SEG) {
    const int lo = max(c_lo, hi - CARRY_SEG + 1), len = hi - lo + 1;
    __syncthreads();  // the last segment is done with
    for (int x = tid; x < 3 * len * K; x += CARRY_THREADS) {
      const int which = x / (len * K), cc = lo + x % (len * K) / K, kk = x % K;
      const int src = which == 0 ? SUM_R : which == 1 ? SUM_Q : SUM_P;
      seg[(which * CARRY_SEG + cc - lo) * K + kk] =
          sums[src * plane + (long long)(cc + (which ? 1 : 0)) * K + kk];
    }
    __syncthreads();
    if (tid < K)
      for (int cc = hi; cc >= lo; --cc) {
        const int i = cc - lo;
        run = (seg[(CARRY_SEG + i) * K + tid] - seg[i * K + tid]) +
              (seg[(2 * CARRY_SEG + i) * K + tid] + run);
        if (cc <= c_hi) sm[(cc - c_lo) * K + tid] = run;
      }
  }
  if (tid < K && blockIdx.x == 0) {
    float du = 0.f;
    for (int cc = 0; cc < nc; ++cc) du += sums[SUM_DU * plane + (long long)cc * K + tid];
    p.du_part[bh * K + tid] = du;
  }
  __syncthreads();
  // each thread adds to four channels of CARRY_CHUNKS C K / (4 CARRY_THREADS)
  // tokens, four loads in flight before their stores
  const int t0 = c_lo * C, n = min((c_hi + 1) * C, p.T) - t0;
  float* dwb = p.dlw + b * p.st[DW_][0] + h * p.st[DW_][1];
  constexpr int Q4 = K / 4, PER = CARRY_CHUNKS * C * Q4 / CARRY_THREADS, GROUP = 4;
  const bool vec = reinterpret_cast<uintptr_t>(dwb) % 16 == 0 && p.st[DW_][2] % 4 == 0;
#pragma unroll 1
  for (int i0 = 0; i0 < PER; i0 += GROUP) {
    float4 v[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int x = tid + (i0 + i) * CARRY_THREADS, t = x / Q4, k4 = 4 * (x % Q4);
      const float* d = dwb + (long long)(t0 + t) * p.st[DW_][2] + k4;
      if (t < n) v[i] = vec ? *reinterpret_cast<const float4*>(d) : make_float4(d[0], d[1], d[2], d[3]);
    }
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int x = tid + (i0 + i) * CARRY_THREADS, t = x / Q4, k4 = 4 * (x % Q4);
      float* d = dwb + (long long)(t0 + t) * p.st[DW_][2] + k4;
      const float* cy = sm + t / C * K + k4;
      const float4 o = make_float4(v[i].x + cy[0], v[i].y + cy[1], v[i].z + cy[2], v[i].w + cy[3]);
      if (t < n) {
        if (vec) {
          *reinterpret_cast<float4*>(d) = o;
        } else {
          d[0] = o.x; d[1] = o.y; d[2] = o.z; d[3] = o.w;
        }
      }
    }
  }
}

template <typename T, typename TD, int K>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int NVS = SweepShape<K>::NVS;
  auto sweep_k = wkv6_bwd_sweep_kernel<T, TD, K>;
  auto chunk_k = wkv6_bwd_chunk_kernel<T, TD, K>;
  const size_t s1 = SweepSmem<K>::BYTES, s2 = ChunkSmem<K>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(sweep_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chunk_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return err;
  sweep_k<<<dim3(2 * NVS, p.H, p.B), SWEEP_THREADS, s1, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_k<<<dim3(p.n_chunks, p.H, p.B), CHUNK_THREADS, s2, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv6_bwd_carry_kernel<K><<<dim3((p.n_chunks + CARRY_CHUNKS - 1) / CARRY_CHUNKS, p.H, p.B),
                             CARRY_THREADS, (CARRY_CHUNKS + 3 * CARRY_SEG) * K * sizeof(float),
                             stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TD>
cudaError_t dispatch(const Params& p, int K, cudaStream_t stream) {
  switch (K) {
    case 16: return launch<T, TD, 16>(p, stream);
    case 32: return launch<T, TD, 32>(p, stream);
    case 64: return launch<T, TD, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr, const long long* st, int elem) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (st[0] * elem) % 16 == 0 &&
         (st[1] * elem) % 16 == 0 && (st[2] * elem) % 16 == 0;
}

}  // namespace

extern "C" {

// The scratch wkv6_bwd needs, in floats: the edges of S and G, the chunks'
// summaries and the sweeps' parts of Q_T.
long long wkv6_bwd_scratch_floats(int B, int H, int T, int K) {
  const long long nc = (T + C - 1) / C, bh = (long long)B * H;
  const int qp = K == 16 ? SweepShape<16>::QP : K == 32 ? SweepShape<32>::QP : SweepShape<64>::QP;
  return 2 * bh * nc * K * K + N_SUMS * bh * nc * K + bh * qp * K;
}

// dtype, ddtype: 0 = float32, 1 = bfloat16, for r/k/v/dr/dk/dv and for dy.
// log_w, u, s0, ds_final, dlog_w, du_part, ds0 and scratch are float32.
// strides: 27 values, (B, H, T) strides in elements of r, k, v, log_w, dy,
// dr, dk, dv and dlog_w in that order, whose last dim is contiguous; u (H,
// K), s0, ds_final and ds0 (B, H, K, K) and du_part (B, H, K) are
// contiguous and start on 16 bytes, as does scratch
// (wkv6_bwd_scratch_floats(B, H, T, K) floats).  ds_final may be null
// (zero).  Inputs that do not start on 16 bytes are staged with plain loads.
// Three launches on `stream`; returns the first cudaError_t that is not 0,
// else 0.
int wkv6_bwd(const void* r, const void* k, const void* v, const void* log_w, const void* u,
             const void* s0, const void* dy, const void* ds_final, void* dr, void* dk,
             void* dv, void* dlog_w, void* du_part, void* ds0, void* scratch, int dtype,
             int ddtype, int B, int H, int T, int K, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || dtype < 0 || dtype > 1 || ddtype < 0 || ddtype > 1)
    return cudaErrorInvalidValue;
  if (K != 16 && K != 32 && K != 64) return cudaErrorInvalidValue;
  const int nc = (T + C - 1) / C;
  const long long bh = (long long)B * H, edge = bh * nc * K * K;
  float* sc = static_cast<float*>(scratch);
  Params p{r, k, v, static_cast<const float*>(log_w), static_cast<const float*>(u),
           static_cast<const float*>(s0), dy, static_cast<const float*>(ds_final),
           dr, dk, dv, static_cast<float*>(dlog_w), static_cast<float*>(du_part),
           static_cast<float*>(ds0), sc, sc + edge, sc + 2 * edge,
           sc + 2 * edge + N_SUMS * bh * nc * K, B, H, T, nc, {}, false};
  for (int i = 0; i < N_STRIDED; ++i)
    for (int d = 0; d < 3; ++d) p.st[i][d] = strides[3 * i + d];
  const int elem = dtype == 0 ? 4 : 2, delem = ddtype == 0 ? 4 : 2;
  p.aligned = aligned16(r, p.st[R_], elem) && aligned16(k, p.st[K_], elem) &&
              aligned16(v, p.st[V_], elem) && aligned16(log_w, p.st[W_], 4) &&
              aligned16(dy, p.st[DY_], delem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ddtype == 0 ? dispatch<float, float>(p, K, s) : dispatch<float, __nv_bfloat16>(p, K, s);
  return ddtype == 0 ? dispatch<__nv_bfloat16, float>(p, K, s)
                     : dispatch<__nv_bfloat16, __nv_bfloat16>(p, K, s);
}

const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
