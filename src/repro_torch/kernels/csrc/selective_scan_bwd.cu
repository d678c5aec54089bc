// The backward pass of the Mamba-1 (S6) selective scan for Hopper
// (sm_90a), bound to PyTorch with ctypes.
//
// It replaces no TPU kernel: the JAX package leaves the scan and its
// gradient to XLA (src/repro/models/ssm.py, `associative_scan` in chunks of
// 64 tokens).  It was added so that jamba trains: autograd through the
// plain doubling scan keeps (B, 64, d_in, N) fp32 tensors per chunk, per
// doubling level and per layer.
//
// With the forward (selective_scan.cu)
//     a_t = exp(dt_t A),  h_t = a_t h_{t-1} + dtx_t B_t,  y_t = sum_n h_t C_t
// and the gradients dy of y and dh of h_S, the gradient of h_t is
//     G_t = C_t dy_t + a_{t+1} G_{t+1},    G_S-1 = C_S-1 dy_S-1 + dh,
// and, with da_t = G_t h_{t-1} (the gradient of a_t),
//     ddt_t[d]  = sum_n da_t a_t A            ddtx_t[d] = sum_n G_t B_t
//     dB_t[n]   = sum_d G_t dtx_t             dC_t[n]   = sum_d dy_t h_t
//     dA[d, n]  = sum_{b,t} da_t a_t dt_t     dh0       = a_0 G_0.
// The plain version is `ref.selective_scan_backward_reference`; the
// chunked algebra below is mirrored step for step by
// `ref.selective_scan_backward_chunked_reference`.
//
// What bounds it on the H100.  By bytes it reads dt, dtx and dy and writes
// ddt and ddtx, (B, S, d_in) fp32 each, and reads the forward's saved
// states hs (B, S / 64, d_in, N): 1.42 GB at jamba's training shape (B 4,
// S 1024, d_in 16384, N 16), 0.42 ms at 3.35 TB/s.  By operations it does
// 1.07 G token-states there, each an exponential (0.26-0.29 ms on the
// SMs' exp units at one a token and state) and some 30 other instructions
// (about 1.2 ms of issue on 132 SMs): issue, not bytes, is its floor.
//
// What the first design (a thread a state, 64-token chunks walked from
// registers) lost: 18 ms at that shape, 43x its bytes, the same
// ~0.57 us for every sequential token step at every shape.  Each step
// waited on its own global loads (behind a guard, with a 64-register
// buffer leaving few loads in flight), took two full-precision
// exponentials a token and state, ten shuffles a token and state (the sums
// over n for ddt and ddtx, over the warp's channels for dB and dC), and
// two barriers a chunk; 127 registers held two blocks an SM.
//
// This design, per block of BT threads (`selective_scan_bwd_sweep_kernel`):
//   - a thread holds SPT = 4 states of one channel (4 lanes a channel at
//     N 16), so the sums over n for ddt and ddtx are mostly in the thread
//     (log2(N / SPT) shuffle rounds);
//   - each CHUNK = 64-token chunk's inputs (dt, dtx and dy for its tokens x
//     the block's channels, B_t, C_t and its saved state) are staged in
//     shared memory by 16-byte `cp.async` (4-byte where d_in % 4 != 0) in
//     two stages: the next chunk's copies are in flight while this one is
//     walked, and no global load sits between one token and the next;
//   - the chunk is run forward from its saved state once, keeping the
//     first state of each SUB = 16-token sub-chunk (a thread's own, in
//     shared memory); then each sub-chunk, last first, is run again from
//     its first state with a_t and h_t (2 x 16 x SPT values) in registers
//     and walked back, a_t kept for the walk: 1.75 exponentials a token and
//     state, and the saved states no larger than the first design's;
//   - dB and dC are summed over the warp's channels per token by a
//     reduce-scatter (each round halves the values a lane holds: 7 shuffles
//     for 8 values at N 16), written to shared memory, summed over the
//     block's warps in order once a sub-chunk and written as the block's
//     fp32 part (G, B, S, 2, N); `selective_scan_bwd_sum_kernel` adds the
//     G parts in order.
// dA is summed per row and then over the rows in order.  No float atomics:
// two calls give bit-identical gradients.
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 64;  // tokens between the forward's saved states (JAX's chunk)
constexpr int SUB = 16;    // tokens whose a_t and h_t a thread holds in registers
constexpr int SPT = 4;     // states a thread
constexpr int BT = 128;    // threads a block of the sweep
constexpr int WARPS = BT / 32;
constexpr int SUM_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
static_assert(CHUNK % SUB == 0, "a chunk is whole sub-chunks");

struct Params {
  const float* dt;   // (B, S, D)
  const float* dtx;  // (B, S, D)
  const float* bm;   // (B, S, N)
  const float* cm;   // (B, S, N)
  const float* a;    // (D, N)
  const float* hs;   // (B, nc, D, N): the state before each chunk
  const float* dy;   // (B, S, D)
  const float* dh;   // (B, D, N) or null: the gradient of h_S
  float* ddt;        // (B, S, D)
  float* ddtx;       // (B, S, D)
  float* dh0;        // (B, D, N)
  float* da_part;    // (B, D, N): dA of each row
  float* dbc_part;   // (G, B, S, 2, N): dB and dC of each block of channels
  int B, S, D, N;
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

// Chunk c of row b for the block's channels g*CPB ..: dt, dtx, dy
// [CHUNK][CPB], B, C [CHUNK][N]; zeros past S and D, which make a padded
// token an identity step (a = 1, no input, no gradient).
template <int N, int CPB>
__device__ __forceinline__ void stage_inputs(const Params& p, float* st, int b, int g, int c,
                                             int tid) {
  const int t0 = c * CHUNK, len = min(CHUNK, p.S - t0);
  const long long D = p.D;
  if (p.vec) {  // D % 4 == 0: rows of 16-byte pieces
    for (int e = tid * 4; e < CHUNK * CPB; e += BT * 4) {
      const int i = e / CPB, d = g * CPB + e % CPB;
      const int bytes = i < len ? 4 * max(0, min(4, p.D - d)) : 0;
      const long long off = bytes ? ((long long)b * p.S + t0 + i) * D + d : 0;
      cp16(st + e, p.dt + off, bytes);
      cp16(st + CHUNK * CPB + e, p.dtx + off, bytes);
      cp16(st + 2 * CHUNK * CPB + e, p.dy + off, bytes);
    }
  } else {
    for (int e = tid; e < CHUNK * CPB; e += BT) {
      const int i = e / CPB, d = g * CPB + e % CPB;
      const bool ok = i < len && d < p.D;
      const long long off = ok ? ((long long)b * p.S + t0 + i) * D + d : 0;
      cp4(st + e, p.dt + off, ok);
      cp4(st + CHUNK * CPB + e, p.dtx + off, ok);
      cp4(st + 2 * CHUNK * CPB + e, p.dy + off, ok);
    }
  }
  float* sb = st + 3 * CHUNK * CPB;
  for (int e = tid * 4; e < CHUNK * N; e += BT * 4) {  // N % 4 == 0: 16-byte pieces
    const int bytes = e / N < len ? 16 : 0;
    const long long off = bytes ? ((long long)b * p.S + t0) * N + e : 0;
    cp16(sb + e, p.bm + off, bytes);
    cp16(sb + CHUNK * N + e, p.cm + off, bytes);
  }
}

// The inputs, then the chunk's saved state [CPB][N].
template <int N, int CPB>
__device__ __forceinline__ void stage_chunk(const Params& p, float* st, int b, int g, int c,
                                            int tid) {
  stage_inputs<N, CPB>(p, st, b, g, c, tid);
  float* sh = st + 3 * CHUNK * CPB + 2 * CHUNK * N;
  const int nc = (p.S + CHUNK - 1) / CHUNK;
  for (int e = tid * 4; e < CPB * N; e += BT * 4) {
    const int bytes = g * CPB + e / N < p.D ? 16 : 0;
    const long long off = bytes ? (((long long)b * nc + c) * p.D + g * CPB) * N + e : 0;
    cp16(sh + e, p.hs + off, bytes);
  }
}

template <int N>
__global__ void __launch_bounds__(BT) selective_scan_bwd_sweep_kernel(const Params p) {
  constexpr int LPC = N / SPT;   // lanes a channel
  constexpr int CPB = BT / LPC;  // channels a block
  constexpr int M = 2 * SPT;     // dB and dC values a lane adds to a token's sums
  constexpr int STAGE = 3 * CHUNK * CPB + 2 * CHUNK * N + CPB * N;
  // [2][STAGE], then [WARPS][SUB][2N] the warps' dB and dC, then
  // [CHUNK / SUB - 1][SPT][BT] the later sub-chunks' first states
  extern __shared__ __align__(16) float smem[];
  float* sbc = smem + 2 * STAGE;
  float* sfirst = sbc + WARPS * SUB * 2 * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = tid / LPC, n0 = (tid % LPC) * SPT;
  const int g = blockIdx.x, b = blockIdx.y;
  const long long D = p.D, S = p.S;
  const int nc = (p.S + CHUNK - 1) / CHUNK;
  const int d = g * CPB + ch;
  const bool live = d < p.D;  // a dead lane computes zeros and stores nothing
  const long long dn = ((long long)b * D + (live ? d : 0)) * N + n0;
  float A[SPT], carry[SPT], dA[SPT];
#pragma unroll
  for (int s = 0; s < SPT; ++s) {
    A[s] = live ? p.a[(long long)d * N + n0 + s] : 0.f;
    dA[s] = 0.f;
    carry[s] = live && p.dh != nullptr ? p.dh[dn + s] : 0.f;
  }
  // the sum this lane holds after the reduce-scatter: dB (j < SPT) or dC of state n0 + j % SPT
  int j = 0;
#pragma unroll
  for (int r = 0; (M >> r) > 1; ++r)
    if (lane & (LPC << r)) j += M >> (r + 1);
  const int slot = (j < SPT ? 0 : N) + n0 + j % SPT;

  stage_chunk<N, CPB>(p, smem, b, g, nc - 1, tid);
  cp_commit();
  for (int c = nc - 1, k = 0; c >= 0; --c, ++k) {
    const float* st = smem + (k & 1) * STAGE;
    if (c > 0) stage_chunk<N, CPB>(p, smem + ((k + 1) & 1) * STAGE, b, g, c - 1, tid);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const int t0 = c * CHUNK, len = min(CHUNK, p.S - t0);
    // the chunk's inputs by its token i, from the stage
    auto in_dt = [&](int i) { return st[i * CPB + ch]; };
    auto in_dtx = [&](int i) { return st[(CHUNK + i) * CPB + ch]; };
    auto in_dy = [&](int i) { return st[(2 * CHUNK + i) * CPB + ch]; };
    auto in_b = [&](int i, int s) { return st[3 * CHUNK * CPB + i * N + n0 + s]; };
    auto in_c = [&](int i, int s) { return st[3 * CHUNK * CPB + (CHUNK + i) * N + n0 + s]; };
    const float* sh = st + 3 * CHUNK * CPB + 2 * CHUNK * N + ch * N + n0;
    const int nq = (len + SUB - 1) / SUB;
    {  // the chunk run forward from its saved state: each later sub-chunk's first state
      float h[SPT];
#pragma unroll
      for (int s = 0; s < SPT; ++s) h[s] = sh[s];
      for (int q = 1; q < nq; ++q) {
#pragma unroll
        for (int i0 = 0; i0 < SUB; ++i0) {
          const int i = (q - 1) * SUB + i0;
          const float dtv = in_dt(i), xv = in_dtx(i);
#pragma unroll
          for (int s = 0; s < SPT; ++s) h[s] = expf(dtv * A[s]) * h[s] + xv * in_b(i, s);
        }
#pragma unroll
        for (int s = 0; s < SPT; ++s) sfirst[((q - 1) * SPT + s) * BT + tid] = h[s];
      }
    }
    for (int q = nq - 1; q >= 0; --q) {
      const int u0 = q * SUB, ulen = min(SUB, len - u0);
      float hst[SPT];
#pragma unroll
      for (int s = 0; s < SPT; ++s)
        hst[s] = q == 0 ? sh[s] : sfirst[((q - 1) * SPT + s) * BT + tid];
      // the sub-chunk run again from its first state, a_t and h_t kept in registers
      float abuf[SUB][SPT], hbuf[SUB][SPT];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const float dtv = in_dt(u0 + i), xv = in_dtx(u0 + i);
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
          abuf[i][s] = expf(dtv * A[s]);
          hbuf[i][s] = abuf[i][s] * (i > 0 ? hbuf[i - 1][s] : hst[s]) + xv * in_b(u0 + i, s);
        }
      }
      // and walked back, carrying G
      float* out_ddt = p.ddt + ((long long)b * S + t0 + u0) * D + d;
      float* out_ddtx = p.ddtx + ((long long)b * S + t0 + u0) * D + d;
#pragma unroll
      for (int i = SUB - 1; i >= 0; --i) {
        const float dtv = in_dt(u0 + i), xv = in_dtx(u0 + i), dyv = in_dy(u0 + i);
        float gdt = 0.f, gdx = 0.f, v[M];
#pragma unroll
        for (int s = 0; s < SPT; ++s) {
          const float at = abuf[i][s];  // kept from the rerun
          const float gt = in_c(u0 + i, s) * dyv + carry[s];
          const float da = gt * (i > 0 ? hbuf[i - 1][s] : hst[s]) * at;  // the gradient of dt A
          gdt += da * A[s];
          gdx += gt * in_b(u0 + i, s);
          dA[s] += da * dtv;
          v[s] = gt * xv;
          v[SPT + s] = dyv * hbuf[i][s];
          carry[s] = at * gt;
        }
#pragma unroll
        for (int o = 1; o < LPC; o <<= 1) {  // over the channel's lanes
          gdt += __shfl_xor_sync(FULL, gdt, o);
          gdx += __shfl_xor_sync(FULL, gdx, o);
        }
        if (n0 == 0 && live && i < ulen) {
          out_ddt[i * D] = gdt;
          out_ddtx[i * D] = gdx;
        }
        // over the warp's channels: each round a lane keeps half its values
        // and adds its partner's other half, until it holds one sum
#pragma unroll
        for (int r = 0; (M >> r) > 1; ++r) {
          const int o = LPC << r, half = M >> (r + 1);
          const bool upper = lane & o;
#pragma unroll
          for (int k2 = 0; k2 < half; ++k2) {
            const float send = upper ? v[k2] : v[k2 + half];
            const float keep = upper ? v[k2 + half] : v[k2];
            v[k2] = keep + __shfl_xor_sync(FULL, send, o);
          }
        }
#pragma unroll
        for (int o = 2 * N; o < 32; o <<= 1) v[0] += __shfl_xor_sync(FULL, v[0], o);
        if (lane < 2 * N) sbc[(warp * SUB + i) * 2 * N + slot] = v[0];
      }
      __syncthreads();
      // the sub-chunk's dB and dC over the block's warps, in order, into its part
      float* part = p.dbc_part + (((long long)g * p.B + b) * S + t0 + u0) * 2 * N;
      for (int e = tid; e < ulen * 2 * N; e += BT) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += sbc[w * SUB * 2 * N + e];
        part[e] = sum;
      }
      __syncthreads();  // before sbc, and the next chunk's stage over this one, are written
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      p.da_part[dn + s] = dA[s];
      p.dh0[dn + s] = carry[s];
    }
  }
}

// dB and dC as the G blocks' parts summed in order, dA as the rows' parts
// summed in order.
__global__ void __launch_bounds__(SUM_THREADS)
selective_scan_bwd_sum_kernel(const float* dbc_part, const float* da_part, float* db, float* dc,
                              float* da, int G, int rows, long long nbc, long long nda, int N) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i < nbc) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += __ldg(dbc_part + g * nbc + i);
    const long long bt = i / (2 * N), k = (i / N) % 2, n = i % N;
    (k == 0 ? db : dc)[bt * N + n] = s;
  } else if (i < nbc + nda) {
    const long long j = i - nbc;
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += __ldg(da_part + r * nda + j);
    da[j] = s;
  }
}

constexpr int channels(int N) { return BT / (N / SPT); }

template <int N>
cudaError_t launch(const Params& p, float* db, float* dc, float* da, cudaStream_t stream) {
  constexpr int CPB = channels(N);
  constexpr int smem = (2 * (3 * CHUNK * CPB + 2 * CHUNK * N + CPB * N) + WARPS * SUB * 2 * N +
                        (CHUNK / SUB - 1) * SPT * BT) * sizeof(float);
  const int groups = (p.D + CPB - 1) / CPB;
  cudaError_t err = cudaFuncSetAttribute(selective_scan_bwd_sweep_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  selective_scan_bwd_sweep_kernel<N><<<dim3(groups, p.B), BT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long nbc = (long long)p.B * p.S * 2 * N, nda = (long long)p.D * N;
  selective_scan_bwd_sum_kernel<<<(nbc + nda + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                                  stream>>>(p.dbc_part, p.da_part, db, dc, da, groups, p.B, nbc,
                                            nda, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The channels one block of the sweep takes: its parts' count is
// ceil(D / this).
int selective_scan_bwd_channels(int N) { return channels(N); }

// All tensors float32, contiguous and 16-byte aligned: dt, dtx, dy, ddt and
// ddtx (B, S, D); bm, cm, db and dc (B, S, N); a and da (D, N); hs (B,
// ceil(S / chunk), D, N), the forward's saved states; dh (null: zero) and
// dh0 (B, D, N); scratch: da_part (B, D, N), dbc_part (ceil(D / channels),
// B, S, 2, N).  N in {4, 8, 16}; chunk must be CHUNK, the forward's.  Two
// launches on `stream`; returns the first cudaError_t that is not 0, else 0.
int selective_scan_bwd(const float* dt, const float* dtx, const float* bm, const float* cm,
                       const float* a, const float* hs, const float* dy, const float* dh,
                       float* ddt, float* ddtx, float* db, float* dc, float* da, float* dh0,
                       float* da_part, float* dbc_part, int B, int S, int D, int N, int chunk,
                       void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || chunk != CHUNK) return cudaErrorInvalidValue;
  Params p{dt, dtx, bm, cm, a, hs, dy, dh, ddt, ddtx, dh0, da_part, dbc_part, B, S, D, N,
           D % 4 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(p, db, dc, da, s);
    case 8: return launch<8>(p, db, dc, da, s);
    case 16: return launch<16>(p, db, dc, da, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* selective_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
