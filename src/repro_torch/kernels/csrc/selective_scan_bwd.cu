// Backward of the Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// the Mamba mixer's chunked associative scan (src/repro/models/mamba.py,
// _chunk_scan under jax.grad).  It is the gradient of csrc/selective_scan.cu.
// Per batch row b and channel d, with N states,
//   h_t = e_t o h_{t-1} + dt_t x_t B_t,  e_t = exp(dt_t a),
//   y_t = h_t . C_t + D x_t,
// walking t backward with dh (the gradient of h_t from later steps):
//   dh     += dy_t C_t
//   dC_t   += dy_t h_t               (summed over d)
//   dB_t   += dh dt_t x_t            (summed over d)
//   dx_t    = D dy_t + dt_t (dh . B_t)
//   ddt_t   = dh . (a o e_t o h_{t-1} + x_t B_t)
//   dA     += dh dt_t e_t o h_{t-1}  dD += dy_t x_t   (summed over b, t)
//   dh     <- e_t o dh
// starting from the final state's gradient (dh_fin, or zero).
// Contract (all f32, contiguous):
//   x, dt, dy  [B, S, D]    b, c  [B, S, N]    a  [D, N]    d  [D]
//   ckpt  [B, D, ceil(S / CKPT_EVERY), N]  the forward's h before steps 0,
//         CKPT_EVERY, ... (csrc/selective_scan.cu, given a ckpt pointer)
//   dh_fin [B, D, N] or null
//   dx, ddt  [B, S, D]
//   db_part, dc_part  [blocks, B, S, N]  (dB and dC of each block's
//         channels; the wrapper sums the blocks in a fixed order)
//   da_part [B, D, N], dd_part [B, D]   (summed over B by the wrapper)
// No floating-point atomics: every output element has one writer, so two
// runs give the same bits.
//
// What bounds it: x, dt, dy, dx and ddt move once (20 bytes per (b, t, d)),
// against one exp and ~16 f32 operations per (b, t, d, n): at N = 16 the
// special-function unit and the bytes set nearly the same floor; in
// practice the serial chain in t and the exchanges between threads.
//
// Design:
// * NPT = 4 states a thread, L = N / 4 lanes a channel (adjacent lanes), as
//   the forward's tiles; blocks of 256 threads over D, one batch row each.
// * h_{t-1} is needed while t runs backward.  The chunk of CKPT_EVERY steps
//   is replayed forward from its checkpoint, keeping h at the start of each
//   sub-chunk of T steps in shared memory (each thread its own words); each
//   sub-chunk, last first, is then replayed from there with its T states in
//   registers and walked back.  The replay repeats the forward's arithmetic
//   (ex2.approx of dt * a * log2(e), the same fmas), so the states are the
//   forward's bits.
// * dx and ddt meet over a channel's L lanes by xor shuffles.  dB and dC
//   meet over a warp's channels by a reduce-scatter of shuffles (each round
//   halves the values a lane holds), then over the block's warps in shared
//   memory, in warp order, into the block's partial.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int CKPT_EVERY = 64;       // csrc/selective_scan.cu
constexpr int T = 8;                 // steps a sub-chunk (states in registers)
constexpr int SUBS = CKPT_EVERY / T;
constexpr int NPT = 4;               // states a thread
constexpr int V = 2 * NPT;           // dB and dC partials a thread and step
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

template <int N>
struct Tile {
  static constexpr int L = N / NPT;            // lanes a channel
  static constexpr int CW = 32 / L;            // channels a warp
  static constexpr int CH = kThreads / L;      // channels a block
  static constexpr int LOGR = ilog2(CW);       // rounds over a warp's channels
  // values a lane keeps after the reduce-scatter (at least one)
  static constexpr int KEEP = V >> LOGR > 0 ? V >> LOGR : 1;
  // shared memory: sub-chunk states [SUBS][NPT][kThreads], warp partials
  // [kWarps][T][2][N]
  static constexpr int SMEM = 4 * (SUBS * NPT * kThreads + kWarps * T * 2 * N);
  static_assert(N % NPT == 0 && L <= 32, "4 states a lane, a channel a warp");
};

// The V values of every lane summed over the CW channels of its warp
// (lanes L apart): round k halves what a lane holds (the upper or lower
// half by its channel bit k), or, once one value is left, adds it across.
// ``idx`` accumulates the index of the lane's first kept value.
template <int H, int K, int LOGR>
struct Scatter {
  __device__ __forceinline__ static void run(float (&v)[V], int lane, int l,
                                             int& idx) {
    if constexpr (K < LOGR) {
      const int off = l << K;
      const bool hi = (lane & off) != 0;
      if constexpr (H > 1) {
        constexpr int HALF = H / 2;
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const float send = hi ? v[i] : v[i + HALF];
          const float keep = hi ? v[i + HALF] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
        if (hi) idx += HALF;
        Scatter<HALF, K + 1, LOGR>::run(v, lane, l, idx);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
        Scatter<1, K + 1, LOGR>::run(v, lane, l, idx);
      }
    }
  }
};

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dd,
    const float* __restrict__ dy, const float* __restrict__ ckpt,
    const float* __restrict__ dh_fin, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ db_part,
    float* __restrict__ dc_part, float* __restrict__ da_part,
    float* __restrict__ dd_part, int batch, int seq, int dim) {
  using Tl = Tile<N>;
  constexpr int L = Tl::L, CW = Tl::CW;
  extern __shared__ float4 smem4[];
  float* sub = reinterpret_cast<float*>(smem4);  // [SUBS][NPT][kThreads]
  float* wpart = sub + SUBS * NPT * kThreads;     // [kWarps][T][2][N]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int part = lane % L, col = lane / L;      // lanes of a channel adjoin
  const int d = blockIdx.x * Tl::CH + warp * CW + col;
  const bool live = d < dim;
  const int b = blockIdx.y;
  const long long row = (long long)b * seq;       // first step of b
  const int nchk = (seq + CKPT_EVERY - 1) / CKPT_EVERY;

  float an[NPT], a2[NPT], dh[NPT], da[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    an[i] = live ? a[(long long)d * N + part * NPT + i] : 0.f;
    a2[i] = an[i] * kLog2e;
    dh[i] = live && dh_fin != nullptr
                ? dh_fin[((long long)b * dim + d) * N + part * NPT + i]
                : 0.f;
    da[i] = 0.f;
  }
  const float dskip = live ? dd[d] : 0.f;
  float dd_acc = 0.f;

  // x_t, dt_t (and dy_t) of the thread's channel, B_t of its states
  auto load = [&](int t, float& xc, float& dtc, float (&bv)[NPT]) {
    const long long o = (row + t) * dim + d;
    xc = live ? __ldg(x + o) : 0.f;
    dtc = live ? __ldg(dt + o) : 0.f;
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(
        bm + (row + t) * N + part * NPT));
    bv[0] = b4.x, bv[1] = b4.y, bv[2] = b4.z, bv[3] = b4.w;
  };
  auto advance = [&](float (&h)[NPT], int t) {   // the forward's step
    float xc, dtc, bv[NPT];
    load(t, xc, dtc, bv);
    const float dtx = dtc * xc;
#pragma unroll
    for (int i = 0; i < NPT; ++i) h[i] = fmaf(ex2(dtc * a2[i]), h[i], dtx * bv[i]);
  };

  for (int j = nchk - 1; j >= 0; --j) {
    const int t0 = j * CKPT_EVERY, len = min(CKPT_EVERY, seq - t0);
    const int nsub = (len + T - 1) / T;
    float h[NPT];
    if (live) {
      const float4 c4 = *reinterpret_cast<const float4*>(
          ckpt + (((long long)b * dim + d) * nchk + j) * N + part * NPT);
      h[0] = c4.x, h[1] = c4.y, h[2] = c4.z, h[3] = c4.w;
    } else {
#pragma unroll
      for (int i = 0; i < NPT; ++i) h[i] = 0.f;
    }
    for (int i = 0; i < nsub; ++i) {             // h at each sub-chunk
#pragma unroll
      for (int e = 0; e < NPT; ++e) sub[(i * NPT + e) * kThreads + tid] = h[e];
      if (i == nsub - 1) break;
#pragma unroll
      for (int c = 0; c < T; ++c) advance(h, t0 + i * T + c);
    }
    for (int i = nsub - 1; i >= 0; --i) {
      const int ts = t0 + i * T, sl = min(T, seq - ts);
      float hist[T][NPT];                        // h_{t-1}, t = ts + c
#pragma unroll
      for (int e = 0; e < NPT; ++e) h[e] = sub[(i * NPT + e) * kThreads + tid];
#pragma unroll
      for (int c = 0; c < T; ++c) {
#pragma unroll
        for (int e = 0; e < NPT; ++e) hist[c][e] = h[e];
        if (c + 1 < sl) advance(h, ts + c);
      }
#pragma unroll
      for (int c = T - 1; c >= 0; --c) {
        if (c >= sl) continue;                   // the same in every thread
        const int t = ts + c;
        float xc, dtc, bv[NPT];
        load(t, xc, dtc, bv);
        const long long o = (row + t) * dim + d;
        const float dyc = live ? __ldg(dy + o) : 0.f;
        const float4 c4 = __ldg(reinterpret_cast<const float4*>(
            cm + (row + t) * N + part * NPT));
        const float cv[NPT] = {c4.x, c4.y, c4.z, c4.w};
        const float dtx = dtc * xc;
        float v[V], sx = 0.f, sdt = 0.f;
#pragma unroll
        for (int e = 0; e < NPT; ++e) {
          const float en = ex2(dtc * a2[e]);
          const float hp = hist[c][e];
          const float ht = fmaf(en, hp, dtx * bv[e]);
          dh[e] = fmaf(dyc, cv[e], dh[e]);
          v[e] = dh[e] * dtx;                    // dB
          v[NPT + e] = dyc * ht;                 // dC
          sx = fmaf(dh[e], bv[e], sx);
          sdt = fmaf(dh[e], fmaf(an[e] * en, hp, xc * bv[e]), sdt);
          da[e] = fmaf(dh[e] * dtc, en * hp, da[e]);
          dh[e] *= en;
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) {   // over the channel
          sx += __shfl_xor_sync(0xffffffffu, sx, off);
          sdt += __shfl_xor_sync(0xffffffffu, sdt, off);
        }
        if (live && part == 0) {
          dx[o] = fmaf(dskip, dyc, dtc * sx);
          ddt[o] = sdt;
          dd_acc = fmaf(dyc, xc, dd_acc);
        }
        int idx = 0;
        Scatter<V, 0, Tl::LOGR>::run(v, lane, L, idx);
        float* dst = wpart + (warp * T + c) * 2 * N;
#pragma unroll
        for (int q = 0; q < Tl::KEEP; ++q) {     // duplicates write alike
          const int vi = idx + q;
          dst[(vi < NPT ? 0 : N) + part * NPT + vi % NPT] = v[q];
        }
      }
      __syncthreads();
      for (int e = tid; e < sl * 2 * N; e += kThreads) {  // warps in order
        const int c = e / (2 * N), rem = e % (2 * N);
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += wpart[(w * T + c) * 2 * N + rem];
        const long long out =
            (((long long)blockIdx.x * batch + b) * seq + ts + c) * N + rem % N;
        (rem < N ? db_part : dc_part)[out] = s;
      }
      __syncthreads();
    }
  }
  if (live) {
#pragma unroll
    for (int e = 0; e < NPT; ++e)
      da_part[((long long)b * dim + d) * N + part * NPT + e] = da[e];
    if (part == 0) dd_part[(long long)b * dim + d] = dd_acc;
  }
}

template <int N>
int launch(const float* x, const float* dt, const float* b, const float* c,
           const float* a, const float* d, const float* dy, const float* ckpt,
           const float* dh_fin, float* dx, float* ddt, float* db_part,
           float* dc_part, float* da_part, float* dd_part, int B, int S,
           int D, cudaStream_t stream) {
  using Tl = Tile<N>;
  cudaError_t e = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((D + Tl::CH - 1) / Tl::CH, B);
  selective_scan_bwd_kernel<N><<<grid, kThreads, Tl::SMEM, stream>>>(
      x, dt, b, c, a, d, dy, ckpt, dh_fin, dx, ddt, db_part, dc_part,
      da_part, dd_part, B, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dh_fin may be null (the final state's gradient is zero); N in 4, 8, 16,
// 32, 64 (kernels/selective_scan.py STATE_SIZES), others return
// cudaErrorInvalidValue.  db_part and dc_part have ceil(D / (256 / (N / 4)))
// blocks (kernels/selective_scan.py bwd_blocks).
extern "C" int selective_scan_bwd_f32(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a, const void* d, const void* dy, const void* ckpt,
    const void* dh_fin, void* dx, void* ddt, void* db_part, void* dc_part,
    void* da_part, void* dd_part, int B, int S, int D, int N, void* stream) {
  const float *xf = (const float*)x, *dtf = (const float*)dt,
              *bf = (const float*)b, *cf = (const float*)c,
              *af = (const float*)a, *df = (const float*)d,
              *dyf = (const float*)dy, *kf = (const float*)ckpt,
              *hf = (const float*)dh_fin;
  float *dxf = (float*)dx, *ddtf = (float*)ddt, *dbf = (float*)db_part,
        *dcf = (float*)dc_part, *daf = (float*)da_part,
        *ddf = (float*)dd_part;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_BWD(NN)                                                    \
  if (N == NN)                                                           \
    return launch<NN>(xf, dtf, bf, cf, af, df, dyf, kf, hf, dxf, ddtf,   \
                      dbf, dcf, daf, ddf, B, S, D, s);
  REPRO_BWD(4) REPRO_BWD(8) REPRO_BWD(16) REPRO_BWD(32) REPRO_BWD(64)
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}
