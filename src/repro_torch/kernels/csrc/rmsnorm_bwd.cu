// The RMSNorm backward for Hopper (sm_90a), bound to PyTorch with ctypes.
//
// Port-side kernel: the Pallas TPU kernel `_rmsnorm_kernel` / `rmsnorm` of
// src/repro/kernels/rmsnorm.py is the forward only, and JAX leaves its
// gradient to XLA.  For y = x r scale with r = rsqrt(mean(x^2) + eps) and
// the gradient g of y, per row, with statistics in fp32:
//     dx     = r (g scale) - x r^3 mean(x g scale)     in x's dtype
//     dscale = sum over rows of g x r                   in scale's dtype
//
// What bounds it on the H100: bytes.  x and g are read once and dx written
// once: at gemma-2b's training shape (4096, 2048) bf16, 50.3 MB, 0.0150 ms
// at 3.35 TB/s.  About 11 operations an element are far below the CUDA
// cores' rate.
//
// What held the first (Triton) version back: each program walked 16 rows one
// after another, and each row's two reductions waited on its own loads, so
// about two rows were in flight per SM; a second launch summed the 256
// programs' partial rows on 32 programs.
//
// What this design does:
//   * The row kernel runs at most one block of 512 threads per SM, each
//     block over a contiguous slice of rows.  The block is split into teams
//     of TT threads, TT the power of two that covers a row at E = 16
//     elements a thread (E = 32 above d = 8192): 4 teams of 128 at d = 2048.
//     A team takes R rows at a time (2 in bf16, 1 in fp32); a thread reads
//     its E elements of each row in 16-byte pieces, neighbouring threads on
//     neighbouring bytes.
//   * The rows stream through a ring of three steps in shared memory
//     (192 KB): each thread copies its own 16-byte pieces with cp.async two
//     steps ahead of the one it computes and reads back only those, so the
//     ring needs no barrier, and each SM keeps ~128 KB of loads in flight
//     while it reduces a step's two row sums (shuffles, then the team's
//     warps through shared memory behind one named barrier of the team).
//   * dscale is the same in every run, with no floating-point atomics: each
//     thread sums g x r over its team's rows in order, and each block adds
//     its teams in order into one fp32 partial row.  A second launch,
//     column_sum_kernel, spreads the sum of the partial rows over d / 16
//     blocks (128 at d = 2048): 16 threads a column each add every 16th
//     partial row in order, and the 16 sums are added in order.  It is an
//     ordinary launch, so the two kernels' times never overlap.  Summing
//     the partial rows in the row kernel instead (the last block of each
//     group to draw an integer ticket after __threadfence) was slower in
//     development: its fences wait for the whole launch's stores to drain,
//     and two levels of fence, ticket and reads follow.
//     ref.rmsnorm_backward_blocked forms the sums in this order on the CPU.
//   * A row width that is not a multiple of 16 bytes, or an x or g that does
//     not start on 16 bytes, takes scalar loads into registers instead
//     (VEC = 1, no ring).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 16;    // columns of a column_sum_kernel block
constexpr int PHASES = 16;  // threads of a column there, each adding every PHASES-th partial row

// rows a team takes at a time: two rows of 16 bf16 a thread, else one
__host__ __device__ constexpr int rows_per_step(int elems, int elem_size) {
  return elems * elem_size <= 32 ? 2 : 1;
}

struct Params {
  const void* x; const void* s; const void* g; void* dx; void* ds;
  float* part;  // (blocks, d) fp32: each block's partial row of dscale
  int rows, d, rows_per_block, team_threads, blocks;
  float eps;
  bool s_bf16;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC elements of T: one 16-byte word, or one element when VEC = 1.
template <typename T, int VEC> struct Pack { uint4 w; };
template <typename T> struct Pack<T, 1> { T w; };

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p, bool ok) {
  Pack<T, VEC> r;
  if constexpr (VEC == 1) {
    r.w = ok ? *p : from_float<T>(0.f);
  } else {
    r.w = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Pack<T, VEC>& a, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_float(a.w);
  } else if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(a.w.x); f[1] = __uint_as_float(a.w.y);
    f[2] = __uint_as_float(a.w.z); f[3] = __uint_as_float(a.w.w);
  } else {  // 8 bf16: a bf16 is the upper half of the fp32 with the same value
    const uint32_t u[4] = {a.w.x, a.w.y, a.w.z, a.w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_float<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

__device__ __forceinline__ float scale_at(const Params& p, int col) {
  return p.s_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.s)[col])
                  : static_cast<const float*>(p.s)[col];
}

// The named barrier of one team (barrier 0 is __syncthreads).
__device__ __forceinline__ void team_sync(int team, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(team + 1), "r"(threads) : "memory");
}

// 16 bytes global -> shared, asynchronously; with full == false nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The ring of steps in flight: three steps of 128 bytes a thread (R rows of
// x and g at E elements), fewer when a step is larger.
constexpr int RING_BYTES = 3 * THREADS * 128;

template <typename T, int E> __host__ __device__ constexpr int ring_stages() {
  return RING_BYTES / (THREADS * rows_per_step(E, sizeof(T)) * 2 * E * (int)sizeof(T));
}

template <typename T, int VEC, int E>
__global__ void __launch_bounds__(THREADS, 1)
rmsnorm_bwd_kernel(const Params p) {
  constexpr int NV = E / VEC;                          // pieces of a row per thread
  constexpr int R = rows_per_step(E, sizeof(T));       // rows a team takes at a time
  constexpr bool RING = VEC > 1;                       // 16-byte pieces: through the ring
  constexpr int S = RING ? ring_stages<T, E>() : 1;    // steps in the ring
  constexpr bool S_REGS = E == 16;                     // the scale in registers
  constexpr int COMB = E == 16 ? (THREADS - 32) * E : 1;  // teams 1.. of at most 16
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) uint4 ring[];  // [S][R][x, g][NV][THREADS]: a thread's own pieces
  __shared__ float red[2][WARPS][2 * R];         // each warp's row sums, by step parity
  __shared__ float comb[COMB];                   // teams 1.. hand their column sums to team 0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TT = p.team_threads, teams = THREADS / TT, team_warps = TT / 32;
  const int team = tid / TT, lt = tid % TT;
  const int d = p.d;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int row_end = min(row0 + p.rows_per_block, p.rows);
  const int steps = p.rows_per_block / (teams * R);
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  T* dx = static_cast<T*>(p.dx);

  // piece v of this thread: columns VEC (v TT + lt) .. + VEC - 1
  auto row_of = [&](int k, int j) { return row0 + (k * teams + team) * R + j; };
  auto slot = [&](int s, int j, int t, int v) {
    return ring + (((s * R + j) * 2 + t) * NV + v) * THREADS + tid;
  };
  auto issue = [&](int k) {  // step k's pieces into stage k % S (zeros past the rows): one group
    if (k < steps) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int row = row_of(k, j);
        const long long base = (long long)row * d;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int col = VEC * (v * TT + lt);
          const bool ok = row < row_end && col < d;
          cp_async16(slot(k % S, j, 0, v), ok ? x + base + col : x, ok);
          cp_async16(slot(k % S, j, 1, v), ok ? g + base + col : g, ok);
        }
      }
    }
    cp_async_commit();
  };
  auto fetch = [&](int k, P (&xx)[R][NV], P (&gg)[R][NV]) {  // scalar pieces, into registers
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = row_of(k, j);
      const long long base = (long long)row * d;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int col = VEC * (v * TT + lt);
        const bool ok = row < row_end && col < d;
        xx[j][v] = load<T, VEC>(x + base + col, ok);
        gg[j][v] = load<T, VEC>(g + base + col, ok);
      }
    }
  };

  float acc[NV][VEC] = {};
  P cx[R][NV], cg[R][NV];
  if constexpr (RING) {
    for (int k = 0; k < S - 1; ++k) issue(k);
  } else if (steps > 0) {
    fetch(0, cx, cg);
  }
  float sv[S_REGS ? NV : 1][VEC];
  if constexpr (S_REGS) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = VEC * (v * TT + lt) + e;
        sv[v][e] = col < d ? scale_at(p, col) : 0.f;
      }
  }
  auto sc = [&](int v, float (&f)[VEC]) {  // the piece's scale (0 past the row)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if constexpr (S_REGS) {
        f[e] = sv[v][e];
      } else {
        const int col = VEC * (v * TT + lt) + e;
        f[e] = col < d ? scale_at(p, col) : 0.f;
      }
    }
  };

  for (int k = 0; k < steps; ++k) {
    if constexpr (RING) {  // S - 1 steps stay in flight
      issue(k + S - 1);
      cp_async_wait<S - 1>();
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          cx[j][v].w = *slot(k % S, j, 0, v);
          cg[j][v].w = *slot(k % S, j, 1, v);
        }
    }
    // the two row sums, sum x^2 and sum x g scale, of each of the R rows
    float sums[2 * R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float ss = 0.f, xs = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float xv[VEC], gv[VEC], s[VEC];
        unpack<T, VEC>(cx[j][v], xv);
        unpack<T, VEC>(cg[j][v], gv);
        sc(v, s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(xv[e], xv[e], ss);
          xs = fmaf(xv[e], gv[e] * s[e], xs);
        }
      }
      sums[2 * j] = ss;
      sums[2 * j + 1] = xs;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 2 * R; ++i) sums[i] += __shfl_xor_sync(0xffffffffu, sums[i], off);
    if (team_warps > 1) {  // the team's warps, in order
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 2 * R; ++i) red[k & 1][warp][i] = sums[i];
      }
      team_sync(team, TT);
#pragma unroll
      for (int i = 0; i < 2 * R; ++i) {
        float t = red[k & 1][team * team_warps][i];
        for (int w = 1; w < team_warps; ++w) t += red[k & 1][team * team_warps + w][i];
        sums[i] = t;
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = row_of(k, j);
      const float r = rsqrtf(sums[2 * j] / d + p.eps);
      const float rc = r * r * r * (sums[2 * j + 1] / d);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float xv[VEC], gv[VEC], s[VEC], o[VEC];
        unpack<T, VEC>(cx[j][v], xv);
        unpack<T, VEC>(cg[j][v], gv);
        sc(v, s);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          o[e] = fmaf(-xv[e], rc, r * (gv[e] * s[e]));
          acc[v][e] = fmaf(gv[e] * xv[e], r, acc[v][e]);  // 0 past the rows and columns
        }
        const int col = VEC * (v * TT + lt);
        if (row < row_end && col < d) store<T, VEC>(dx + (long long)row * d + col, o);
      }
    }
    if constexpr (!RING) {
      if (k + 1 < steps) fetch(k + 1, cx, cg);
    }
  }
  if constexpr (RING) cp_async_wait<0>();  // the groups past the rows are empty

  // the block's partial row: its teams' column sums added in team order
  if (teams > 1) {
    if (team > 0) {
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e) comb[((team - 1) * E + v * VEC + e) * TT + lt] = acc[v][e];
    }
    __syncthreads();
    if (team == 0) {
      for (int t = 1; t < teams; ++t)
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[v][e] += comb[((t - 1) * E + v * VEC + e) * TT + lt];
    }
  }
  if (team == 0) {
    float* part = p.part + (long long)blockIdx.x * d;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int col = VEC * (v * TT + lt);
      if (col < d) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[col + e] = acc[v][e];
      }
    }
  }
}

// dscale[c] = the sum over blocks of part[b][c]: thread q of column c adds
// rows q, q + PHASES, .. in order, and the PHASES sums are added in order.
template <int Q>
__global__ void __launch_bounds__(COLS * Q)
column_sum_kernel(const Params p) {
  __shared__ float sums[Q][COLS];
  const int q = threadIdx.x / COLS, cl = threadIdx.x % COLS, c = blockIdx.x * COLS + cl;
  float t = 0.f;
  if (c < p.d) {
#pragma unroll 8
    for (int b = q; b < p.blocks; b += Q) t += __ldg(p.part + (long long)b * p.d + c);
  }
  sums[q][cl] = t;
  __syncthreads();
  if (q == 0 && c < p.d) {
    for (int i = 1; i < Q; ++i) t += sums[i][cl];
    if (p.s_bf16) static_cast<__nv_bfloat16*>(p.ds)[c] = __float2bfloat16(t);
    else static_cast<float*>(p.ds)[c] = t;
  }
}

template <typename T, int E>
cudaError_t launch(const Params& p, bool vec, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (!vec) {
    rmsnorm_bwd_kernel<T, 1, E><<<p.blocks, THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
  auto kern = rmsnorm_bwd_kernel<T, VEC, E>;
  constexpr int smem = ring_stages<T, E>() * THREADS * rows_per_step(E, sizeof(T)) * 2 * E *
                       (int)sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<p.blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_sums(const Params& p, cudaStream_t stream) {
  column_sum_kernel<PHASES><<<(p.d + COLS - 1) / COLS, COLS * PHASES, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16 (x, g and dx share one; scale and
// dscale another).  x, g and dx are contiguous (rows, d), scale and dscale
// (d,).  part holds blocks x d floats of scratch.  The split of the rows
// (elems, team_threads, rows_per_block, blocks) is rmsnorm.bwd_plan's.  Two
// launches: the row kernel, then column_sum_kernel.  Returns the first
// cudaError_t of the launches (0 on success).
int rmsnorm_bwd(const void* x, const void* s, const void* g, void* dx, void* ds, void* part,
                int x_dtype, int s_dtype, int rows, int d, int elems, int team_threads,
                int rows_per_block, int blocks, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d > 16384 || x_dtype < 0 || x_dtype > 1 || s_dtype < 0 ||
      s_dtype > 1 || (elems != 16 && elems != 32) || team_threads < 32 ||
      team_threads > THREADS || (team_threads & (team_threads - 1)) ||
      team_threads * elems < d || blocks <= 0 || (long long)rows_per_block * blocks < rows ||
      (long long)rows_per_block * (blocks - 1) >= rows)
    return cudaErrorInvalidValue;
  const int elem = x_dtype == 0 ? 4 : 2;
  const int step_rows = THREADS / team_threads * rows_per_step(elems, elem);
  if (rows_per_block % step_rows) return cudaErrorInvalidValue;
  const bool vec = (d * elem) % 16 == 0 && aligned16(x) && aligned16(g) && aligned16(dx);
  Params p{x, s, g, dx, ds, static_cast<float*>(part), rows, d, rows_per_block, team_threads,
           blocks, eps, s_dtype == 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0)
    err = elems == 16 ? launch<float, 16>(p, vec, st) : launch<float, 32>(p, vec, st);
  else
    err = elems == 16 ? launch<__nv_bfloat16, 16>(p, vec, st)
                      : launch<__nv_bfloat16, 32>(p, vec, st);
  return err != cudaSuccess ? err : launch_sums(p, st);
}

const char* rmsnorm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
