// The backward pass of the WKV6 recurrence (RWKV-6 "Finch" time mixing)
// for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// The JAX package has no Pallas backward for `_wkv6_kernel` / `wkv6`
// (src/repro/kernels/rwkv6_wkv.py): XLA differentiates ssm.chunked_scan.
// This kernel is the port's own.  Per (batch, head), with the fp32 state S
// (K x V) of the forward,
//     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(log_w_t),
// and the gradients dy_t of y and G_{T-1} = ds_final of the final state, it
// computes, with G_{t-1} = diag(w_t) G_t + r_t dy_t^T and a_t = sum_k r_t u k_t:
//     dr_t     = S_{t-1} dy_t + u . k_t (dy_t . v_t)
//     dk_t     = r_t . u (dy_t . v_t) + G_t v_t
//     dv_t     = a_t dy_t + G_t^T k_t
//     du       = sum over b and t of r_t . k_t (dy_t . v_t)
//     ds0      = G_{-1}
//     dlog_w_t = sum_{s > t} Q_s - sum_{j >= t} R_j,  Q_t = r_t . (S_{t-1} dy_t),
//                R_t = k_t . (G_t v_t),  Q_T = rowsum(ds_final . S_{T-1})
// (the split of RWKV-LM's wkv6_cuda.cu backward; `ref.wkv6_backward_reference`
// is its plain version).  dlog_w needs no stored state and no division by w.
// r, k, v (and dr, dk, dv) in f32 or bf16, dy in f32 or bf16, the rest f32;
// any T >= 1, K = V in {16, 32, 64}; strided (B, H, T, .) views, since the
// model hands in (B, T, H, K) transposed.
//
// What bounds it on the H100: operations.  Per token and head it does ~12
// fp32 operations per state entry (rebuilding S, S dy, the two products
// with G, the G update): 6.44 GFLOP at rwkv6-1.6b's training shape (B=4,
// H=32, T=1024, K=V=64), 0.096 ms at 67 TFLOP/s, against 205.5 MB of
// inputs and outputs (0.061 ms at 3.35 TB/s).
//
// What this first design does (token by token; the chunked tensor-core form
// of the forward kernel is later work):
//   * One block per (b, h) walks the sequence twice with its state in
//     registers: forward to rebuild S, backward with G.  Tokens are staged
//     CT at a time in shared memory as f32 (w = exp(log_w) formed there),
//     the next chunk's loads held in registers while the current chunk
//     runs; dy_t . v_t and a_t are summed once per token at staging.
//   * Thread (row group, column group) holds a tile of R rows by 4 columns
//     of S, then of G (R = 2 at K = 64: blocks of 512 threads), so a value
//     read from shared memory serves R or 4 state entries.
//   * Row sums (S dy, G v) go over the K / 4 lanes of a row group: shuffles
//     that halve the rows a lane holds at each step, then add the last row
//     over the remaining lanes.  A row's writer lane puts dr_t and Q_t in
//     the forward pass, dk_t and dlog_w_t in the backward pass, into shared
//     memory; it folds Q_{t+1} - R_t into one running sum (two suffix sums
//     taken apart would round their large common part separately).
//   * Column sums (G^T k) go over the row groups of a warp by shuffles, then
//     into shared memory per token and warp, summed over the warps once per
//     chunk: nothing later in the walk reads them.
//   * Outputs leave once per chunk, a row of K per token in turn (Q_t into
//     dlog_w's buffer, read back by the backward pass's staging before
//     dlog_w_t overwrites it).
//   * du: one part per (b, h), in token order; the wrapper sums them over
//     b.  No atomics: two calls give bit-identical gradients.
//   * tools/wkv6_bwd_ablation.py times it with its shuffles, its output
//     stores or its backward pass cut out, and with tiles of 4 rows
//     (PERF.md has the numbers).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CT = 16;   // tokens staged per chunk
constexpr int TILE_ROWS = 2;  // rows of a thread's tile of the state, at most
// A thread's tile of the state: R rows by 4 columns, so a block has
// (K / R) (K / 4) threads.
template <int K> __host__ __device__ constexpr int tile_rows() {
  return K / 16 < TILE_ROWS ? K / 16 : TILE_ROWS;
}
template <int K> __host__ __device__ constexpr int block_threads() {
  return K / tile_rows<K>() * (K / 4);
}
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Strides in elements over (B, H, T) of each strided tensor, in this order.
enum { R_, K_, V_, W_, DY_, DR_, DK_, DV_, DW_, N_STRIDED };

struct Params {
  const void* r; const void* k; const void* v; const float* lw; const float* u;
  const float* s0; const void* dy; const float* ds;  // ds may be null (zero)
  void* dr; void* dk; void* dv; float* dlw; float* du_part; float* ds0;
  int H, T;
  long long st[N_STRIDED][3];
};

// N consecutive floats (N = 1, 2 or 4, aligned to N floats).
template <int N>
__device__ __forceinline__ void ldn(float (&dst)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float x = a[0];
#pragma unroll
  for (int e = 1; e < N; ++e)
    if (e == i) x = a[e];
  return x;
}

// x[N] are this lane's parts of N sums over the lanes that differ in the
// bits of HI .. LO (powers of two, HI >= LO).  While a lane holds more than
// one sum, each step halves them: the lane whose bit is set keeps the upper
// half and adds its partner's part of it.  Then the sums are added over the
// remaining bits.  On return x[0 .. N/(HI/LO*2)) (at least one) are whole,
// and `first` is the index of x[0] among the N.
template <int N, int HI, int LO>
__device__ __forceinline__ void reduce_scatter(float (&x)[N], int lane, int& first) {
  first = 0;
  int held = N;
#pragma unroll
  for (int mask = HI; mask >= LO; mask >>= 1) {
    if (held > 1) {
      const bool upper = lane & mask;
      held /= 2;
#pragma unroll
      for (int e = 0; e < N / 2; ++e) {
        if (e < held) {
          const float send = upper ? x[e] : x[e + held];
          const float keep = upper ? x[e + held] : x[e];
          x[e] = keep + __shfl_xor_sync(FULL, send, mask);
        }
      }
      if (upper) first += held;
    } else {
      x[0] += __shfl_xor_sync(FULL, x[0], mask);
    }
  }
}

template <int K>
struct Smem {
  static constexpr int W = block_threads<K>() / 32;  // warps
  static constexpr int RS = 0;                    // r (CT, K) ..
  static constexpr int KS = RS + CT * K;          // k
  static constexpr int VS = KS + CT * K;          // v
  static constexpr int WS = VS + CT * K;          // w = exp(log_w)
  static constexpr int DS = WS + CT * K;          // dy
  static constexpr int QS = DS + CT * K;          // Q (backward pass)
  static constexpr int O1 = QS + CT * K;          // the chunk's dr (forward) or dk (backward)
  static constexpr int O2 = O1 + CT * K;          // the chunk's Q (forward) or dlog_w (backward)
  static constexpr int GK = O2 + CT * K;          // G^T k per token and warp (CT, W, K)
  static constexpr int DYV = GK + CT * W * K;     // dy . v (CT)
  static constexpr int AV = DYV + CT;             // a (CT)
  static constexpr int US = AV + CT;              // u (K)
  static constexpr int QL = US + K;               // Q_T (K)
  static constexpr int FLOATS = QL + K;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

// T: the type of r, k, v, dr, dk and dv; TD: the type of dy.
template <typename T, typename TD, int K>
__global__ void __launch_bounds__(block_threads<K>())
wkv6_bwd_kernel(const Params p) {
  using L = Smem<K>;
  constexpr int THREADS = block_threads<K>(), W = L::W;
  constexpr int R = tile_rows<K>();  // rows of a thread's tile (and 4 columns)
  constexpr int CG = K / 4;          // column groups: the lanes of a row group
  constexpr int RL = CG / R;         // the lanes that end with one row's sums
  constexpr int PER = CT * K / THREADS;  // elements of each staged array a thread loads
  constexpr int TPT = K / PER;       // threads that stage one token (consecutive lanes)
  // the column sums of a warp's row groups: each lane ends with COL_KEPT of
  // its 4 columns, and lanes that differ in the bits COL_COPIES hold the same
  constexpr int COL_KEPT = CG >= 16 ? CG / 8 : 1, COL_COPIES = CG < 8 ? 8 - CG : 0;
  static_assert(CT * K == THREADS * PER && TPT <= 32 && CG <= 16 && RL >= 1,
                "the lanes of a token's staging and of a row group share a warp");

  extern __shared__ __align__(16) float sm[];
  float* Rs = sm + L::RS;  float* Ks = sm + L::KS;  float* Vs = sm + L::VS;
  float* Ws = sm + L::WS;  float* Ds = sm + L::DS;  float* Qs = sm + L::QS;
  float* Gk = sm + L::GK;  float* dyv = sm + L::DYV;  float* av = sm + L::AV;
  float* Us = sm + L::US;  float* Qlast = sm + L::QL;
  float* O1 = sm + L::O1;  float* O2 = sm + L::O2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  auto base = [&](int which) { return b * p.st[which][0] + h * p.st[which][1]; };
  const T* rb = static_cast<const T*>(p.r) + base(R_);
  const T* kb = static_cast<const T*>(p.k) + base(K_);
  const T* vb = static_cast<const T*>(p.v) + base(V_);
  const float* wb = p.lw + base(W_);
  const TD* db = static_cast<const TD*>(p.dy) + base(DY_);
  T* drb = static_cast<T*>(p.dr) + base(DR_);
  T* dkb = static_cast<T*>(p.dk) + base(DK_);
  T* dvb = static_cast<T*>(p.dv) + base(DV_);
  float* dwb = p.dlw + base(DW_);
  const long long sb = ((long long)b * p.H + h) * K * K;  // s0, ds, ds0: contiguous (B, H, K, V)
  for (int i = tid; i < K; i += THREADS) Us[i] = p.u[h * K + i];

  // This thread's tile: rows i0 .. i0 + R - 1, columns j0 .. j0 + 3.
  const int cg = tid % CG, i0 = (tid / CG) * R, j0 = 4 * cg;
  // the row whose sums this lane ends with (reduce_scatter over the row
  // group's lanes), and the one of its RL copies that writes
  const int row = i0 + (lane / RL) % R;
  const bool writer = lane % RL == 0;

  // Staging: this thread loads channels c0 .. c0 + 3 of token tt_of of a chunk.
  const int tt_of = tid * PER / K, c0 = tid * PER % K;
  T pr[PER], pk[PER], pv[PER];
  TD pd[PER];
  float pw[PER], pq[PER];
  auto fetch = [&](int t0, bool with_q) {
    const long long t = t0 + tt_of;
    const bool ok = t < p.T;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int c = c0 + e;
      pr[e] = ok ? rb[t * p.st[R_][2] + c] : from_float<T>(0.f);
      pk[e] = ok ? kb[t * p.st[K_][2] + c] : from_float<T>(0.f);
      pv[e] = ok ? vb[t * p.st[V_][2] + c] : from_float<T>(0.f);
      pw[e] = ok ? wb[t * p.st[W_][2] + c] : 0.f;
      pd[e] = ok ? db[t * p.st[DY_][2] + c] : from_float<TD>(0.f);
      if (with_q) pq[e] = ok ? dwb[t * p.st[DW_][2] + c] : 0.f;  // Q_t, from the forward pass
    }
  };
  // Registers -> shared memory, with dy . v and a = sum r u k of each token
  // summed over its TPT threads (a fixed order: bit-identical between calls).
  auto store = [&](bool with_q) {
    float dv_ = 0.f, a_ = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int c = tt_of * K + c0 + e;
      const float rv = to_float(pr[e]), kv = to_float(pk[e]), vv = to_float(pv[e]);
      const float dd = to_float(pd[e]);
      Rs[c] = rv;
      Ks[c] = kv;
      Vs[c] = vv;
      Ws[c] = expf(pw[e]);
      Ds[c] = dd;
      if (with_q) Qs[c] = pq[e];
      dv_ = fmaf(dd, vv, dv_);
      a_ = fmaf(rv * Us[c0 + e], kv, a_);
    }
#pragma unroll
    for (int m = 1; m < TPT; m <<= 1) {
      dv_ += __shfl_xor_sync(FULL, dv_, m);
      a_ += __shfl_xor_sync(FULL, a_, m);
    }
    if (c0 == 0) {
      dyv[tt_of] = dv_;
      av[tt_of] = a_;
    }
  };
  const int n_chunks = (p.T + CT - 1) / CT;

  // ---- forward in t: rebuild S; dr_t, Q_t and each row's share of du ----
  {
    float S[R][4];
#pragma unroll
    for (int a = 0; a < R; ++a) ldn<4>(S[a], p.s0 + sb + (i0 + a) * K + j0);
    float du = 0.f;
    fetch(0, false);
    for (int c = 0; c < n_chunks; ++c) {
      const int t0 = c * CT, n = min(CT, p.T - t0);
      __syncthreads();  // the previous chunk is done with shared memory (and Us is written)
      store(false);
      __syncthreads();
      if (c + 1 < n_chunks) fetch(t0 + CT, false);  // in flight while this chunk runs
      for (int tt = 0; tt < n; ++tt) {
        float kr[R], wr[R], d[4], vv[4], part[R];
        ldn<R>(kr, Ks + tt * K + i0);
        ldn<R>(wr, Ws + tt * K + i0);
        ldn<4>(d, Ds + tt * K + j0);
        ldn<4>(vv, Vs + tt * K + j0);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          part[a] = S[a][0] * d[0];
#pragma unroll
          for (int e = 1; e < 4; ++e) part[a] = fmaf(S[a][e], d[e], part[a]);
#pragma unroll
          for (int e = 0; e < 4; ++e) S[a][e] = fmaf(wr[a], S[a][e], kr[a] * vv[e]);
        }
        int first;
        reduce_scatter<R, CG / 2, 1>(part, lane, first);  // part[0] = (S_{t-1} dy_t)[row]
        if (writer) {
          const float kk = pick(kr, first), kdyv = kk * dyv[tt], rr = Rs[tt * K + row];
          O1[tt * K + row] = fmaf(Us[row], kdyv, part[0]);  // dr_t
          O2[tt * K + row] = rr * part[0];                  // Q_t
          du = fmaf(rr, kdyv, du);
        }
      }
      __syncthreads();  // the chunk's dr and Q are complete: write them row by row
      for (int x = tid; x < n * K; x += THREADS) {
        const long long t = t0 + x / K;
        drb[t * p.st[DR_][2] + x % K] = from_float<T>(O1[x]);
        dwb[t * p.st[DW_][2] + x % K] = O2[x];
      }
    }
    // Q_T = rowsum(ds_final . S_{T-1}), and the row's share of du
    float part[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      float g[4] = {0.f, 0.f, 0.f, 0.f};
      if (p.ds != nullptr) ldn<4>(g, p.ds + sb + (i0 + a) * K + j0);
      part[a] = S[a][0] * g[0];
#pragma unroll
      for (int e = 1; e < 4; ++e) part[a] = fmaf(S[a][e], g[e], part[a]);
    }
    int first;
    reduce_scatter<R, CG / 2, 1>(part, lane, first);
    if (writer) {
      Qlast[row] = part[0];
      p.du_part[((long long)b * p.H + h) * K + row] = du;
    }
  }
  __syncthreads();  // Q_t in dlog_w's buffer and Qlast are visible to every thread

  // ---- backward in t: G; dk_t and dlog_w_t by rows, dv_t by columns ----
  {
    float G[R][4];
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) G[a][e] = 0.f;
      if (p.ds != nullptr) ldn<4>(G[a], p.ds + sb + (i0 + a) * K + j0);
    }
    float acc = 0.f, q_next = Qlast[row];  // the running dlog_w and Q_{t+1} of this lane's row
    fetch((n_chunks - 1) * CT, true);
    for (int c = n_chunks - 1; c >= 0; --c) {
      const int t0 = c * CT, n = min(CT, p.T - t0);
      __syncthreads();
      store(true);
      __syncthreads();
      if (c > 0) fetch(t0 - CT, true);
      for (int tt = n - 1; tt >= 0; --tt) {
        float kr[R], wr[R], rr[R], d[4], vv[4], gv[R], gk[4];
        ldn<R>(kr, Ks + tt * K + i0);
        ldn<R>(wr, Ws + tt * K + i0);
        ldn<R>(rr, Rs + tt * K + i0);
        ldn<4>(d, Ds + tt * K + j0);
        ldn<4>(vv, Vs + tt * K + j0);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          gv[a] = G[a][0] * vv[0];
#pragma unroll
          for (int e = 1; e < 4; ++e) gv[a] = fmaf(G[a][e], vv[e], gv[a]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gk[e] = G[0][e] * kr[0];
#pragma unroll
          for (int a = 1; a < R; ++a) gk[e] = fmaf(G[a][e], kr[a], gk[e]);
        }
#pragma unroll
        for (int a = 0; a < R; ++a) {
#pragma unroll
          for (int e = 0; e < 4; ++e) G[a][e] = fmaf(wr[a], G[a][e], rr[a] * d[e]);
        }
        // rows: (G_t v_t)[row] over the row group's lanes
        int first;
        reduce_scatter<R, CG / 2, 1>(gv, lane, first);
        acc += q_next - pick(kr, first) * gv[0];  // + Q_{t+1} - R_t
        q_next = Qs[tt * K + row];
        if (writer) {
          const float ru = pick(rr, first) * Us[row];
          O1[tt * K + row] = fmaf(ru, dyv[tt], gv[0]);  // dk_t
          O2[tt * K + row] = acc;                        // dlog_w_t
        }
        // columns: (G_t^T k_t) over the warp's row groups, then per warp into Gk
        int col;
        reduce_scatter<4, 16, CG>(gk, lane, col);
        if ((lane & COL_COPIES) == 0) {
#pragma unroll
          for (int e = 0; e < COL_KEPT; ++e) Gk[(tt * W + warp) * K + j0 + col + e] = gk[e];
        }
      }
      __syncthreads();  // Gk holds every warp's column sums of the chunk, O1 and O2 its rows
      for (int x = tid; x < n * K; x += THREADS) {
        const int tt = x / K, j = x % K;
        float s = Gk[tt * W * K + j];
#pragma unroll
        for (int w = 1; w < W; ++w) s += Gk[(tt * W + w) * K + j];
        const long long t = t0 + tt;
        dvb[t * p.st[DV_][2] + j] = from_float<T>(fmaf(av[tt], Ds[x], s));
        dkb[t * p.st[DK_][2] + j] = from_float<T>(O1[x]);
        dwb[t * p.st[DW_][2] + j] = O2[x];  // over Q_t, which the chunk's staging holds
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {  // ds0 = G_{-1}
      float* dst = p.ds0 + sb + (long long)(i0 + a) * K + j0;
      *reinterpret_cast<float4*>(dst) = make_float4(G[a][0], G[a][1], G[a][2], G[a][3]);
    }
  }
}

template <typename T, typename TD, int K>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  auto kern = wkv6_bwd_kernel<T, TD, K>;
  const size_t smem = Smem<K>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.H, B), block_threads<K>(), smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename TD>
cudaError_t dispatch(const Params& p, int B, int K, cudaStream_t stream) {
  switch (K) {
    case 16: return launch<T, TD, 16>(p, B, stream);
    case 32: return launch<T, TD, 32>(p, B, stream);
    case 64: return launch<T, TD, 64>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype, ddtype: 0 = float32, 1 = bfloat16, for r/k/v/dr/dk/dv and for dy.
// log_w, u, s0, ds_final, dlog_w, du_part and ds0 are float32.  strides:
// 27 values, (B, H, T) strides in elements of r, k, v, log_w, dy, dr, dk,
// dv and dlog_w in that order, whose last dim is contiguous; u (H, K), s0,
// ds_final and ds0 (B, H, K, K) and du_part (B, H, K) are contiguous and
// start on 16 bytes.  ds_final may be null (zero).  Returns the
// cudaError_t of the launch (0 on success).
int wkv6_bwd(const void* r, const void* k, const void* v, const void* log_w, const void* u,
             const void* s0, const void* dy, const void* ds_final, void* dr, void* dk,
             void* dv, void* dlog_w, void* du_part, void* ds0, int dtype, int ddtype, int B,
             int H, int T, int K, const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || dtype < 0 || dtype > 1 || ddtype < 0 || ddtype > 1)
    return cudaErrorInvalidValue;
  Params p{r, k, v, static_cast<const float*>(log_w), static_cast<const float*>(u),
           static_cast<const float*>(s0), dy, static_cast<const float*>(ds_final),
           dr, dk, dv, static_cast<float*>(dlog_w), static_cast<float*>(du_part),
           static_cast<float*>(ds0), H, T, {}};
  for (int i = 0; i < N_STRIDED; ++i)
    for (int d = 0; d < 3; ++d) p.st[i][d] = strides[3 * i + d];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ddtype == 0 ? dispatch<float, float>(p, B, K, s)
                       : dispatch<float, __nv_bfloat16>(p, B, K, s);
  return ddtype == 0 ? dispatch<__nv_bfloat16, float>(p, B, K, s)
                     : dispatch<__nv_bfloat16, __nv_bfloat16>(p, B, K, s);
}

const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
