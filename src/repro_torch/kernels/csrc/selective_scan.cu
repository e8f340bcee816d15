// Mamba-1 selective scan for Hopper (sm_90a), from a zero initial state.
//
// Replaces the TPU kernel selective_scan_pallas (src/repro/kernels/
// selective_scan.py, body _selective_scan_kernel).  Per batch row b and
// channel d, with N states h[n]:
//   h[n]   = exp(dt_t * a[d, n]) * h[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h[n] * C_t[n] + D[d] * x_t
// Contract (all f32, contiguous; x, dt, b and c on a 16-byte boundary):
//   x, dt [B, S, D]    b, c [B, S, N]    a [D, N]    d [D]
//   y     [B, S, D]    h_fin [B, D, N]   (h after the last step)
// The TPU kernel drops the final state; the Mamba prefill hands it to the
// decode cache, so this kernel writes it.  S and D are any size: no padding.
// For training, given a ckpt pointer, it also writes h before every
// CKPT_EVERY-th step, ckpt [B, D, ceil(S / CKPT_EVERY), N], from which
// csrc/selective_scan_bwd.cu recomputes the states it walks back through;
// inference passes null.
//
// What bounds it: x, dt and y move once (12 bytes per (b, t, d)), and each
// (b, t, d, n) takes one exp, so at N = 16 the special-function unit (16
// exps a clock per SM) and device-memory bytes set nearly the same floor;
// in practice the step loop's instruction issue and latency hold it (see
// the measurements in PERF.md).  Design:
// * exp(dt * a) is ex2.approx.ftz(dt * a'), with a' = a * log2(e) kept in
//   registers: one FMUL and one MUFU.EX2 per state and step, then the
//   state's FMA and the output's FMA (relative error of ex2.approx ~2^-22,
//   far inside the 1e-4 tolerance; a result below 2^-126 flushes to 0).
// * L lanes share a channel, N / L states each; their partial y meet by
//   xor shuffles.  The wrapper's plan picks L from the shape (2 at the
//   Jamba prefill, 4 for one long prompt).  The recurrence is serial in t.
// * Each warp stages its own 32 / L channels: chunks of T timesteps of x
//   and dt (16-byte copies, coalesced over d) and of B_t and C_t go through
//   the warp's 3-stage cp.async ring, so the next two chunks load while one
//   runs, and no barrier makes the warps of a block wait for each other
//   (a block-wide ring ran 8% slower at the Jamba shape).  A full chunk's
//   steps are unrolled with y kept in registers, so the compiler overlaps
//   one step's loads and exps with the last one's sums; y goes out in
//   coalesced stores after the chunk.  B_t and C_t are float4 broadcasts.
// * D % 4 != 0 (rows off the 16-byte boundary) takes 4-byte copies.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // 4 warps, each on its own channels
constexpr int kStages = 3;           // chunks in a warp's ring
constexpr int kWarpFloats = 3072;    // a warp's ring: 12 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr int CKPT_EVERY = 64;       // kernels/selective_scan.py CKPT_EVERY

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

template <int N, int L>
struct Tile {
  static constexpr int NPT = N / L;            // states a thread keeps
  static constexpr int CW = 32 / L;            // channels a warp
  static constexpr int CH = kThreads / L;      // channels a block
  // timesteps a chunk: 8 up to 2 lanes a channel, more where a warp has
  // fewer channels (measured: 8 at L 2, 16 at L 4), within the ring
  static constexpr int T = cmin(cmin(32, L <= 2 ? 8 : 4 * L),
                                pow2_floor(kWarpFloats / (kStages * 2 * (CW + N))));
  // one stage: x [T][CW], dt [T][CW], B [T][N], C [T][N]
  static constexpr int STAGE = 2 * T * (CW + N);
  static constexpr int SMEM = 4 * (kThreads / 32) * kStages * STAGE;
  static_assert(NPT >= 1 && NPT <= 8, "1..8 states a thread");
  static_assert(CW % 4 == 0, "a warp's row is whole 16-byte pieces");
  static_assert(CKPT_EVERY % T == 0, "checkpoints on chunk starts");
};

// At 4 or more lanes a channel, a register budget for 6 blocks an SM makes
// the unrolled chunk schedule better (measured on an H100 80GB HBM3 at
// 700 W, B 1, S 2048: 0.158 ms against 0.190); at 2 lanes it cost 2%.
template <int N, int L>
__global__ void __launch_bounds__(kThreads, L >= 4 ? 6 : 1)
selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ dd,
                      float* __restrict__ y, float* __restrict__ h_fin,
                      float* __restrict__ ckpt, int seq, int dim) {
  using S = Tile<N, L>;
  constexpr int NPT = S::NPT, CW = S::CW, T = S::T;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = lane % L, col = lane / L;   // lanes of a channel adjoin
  float* ring = smem + warp * kStages * S::STAGE;
  const int dw = blockIdx.x * S::CH + warp * CW;       // the warp's channels
  const int d = dw + col;
  const int nch = max(0, min(CW, dim - dw));
  const bool live = col < nch;
  const bool vec = dim % 4 == 0;               // rows of 16-byte pieces
  const long long row = (long long)blockIdx.y * seq;   // first step of b
  const int chunks = (seq + T - 1) / T;

  float a2[NPT], h[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    a2[i] = live ? a[(long long)d * N + part * NPT + i] * kLog2e : 0.f;
    h[i] = 0.f;
  }
  const float dskip = live ? dd[d] : 0.f;

  auto issue = [&](int ci) {          // chunk ci into its ring slot
    if (ci < chunks) {
      float* st = ring + (ci % kStages) * S::STAGE;
      const int t0 = ci * T, len = min(T, seq - t0);
      const float* xb = x + (row + t0) * dim + dw;
      const float* db = dt + (row + t0) * dim + dw;
      if (vec) {
        constexpr int PER = CW / 4, NXD = T * PER;
        for (int i = lane; i < 2 * NXD; i += 32) {
          const int which = i / NXD, c = i % NXD / PER, j = i % PER;
          if (c < len && 4 * j < nch)
            cp_async16(st + (which * T + c) * CW + 4 * j,
                       (which ? db : xb) + (long long)c * dim + 4 * j);
        }
      } else {
        constexpr int NXD = T * CW;
        for (int i = lane; i < 2 * NXD; i += 32) {
          const int which = i / NXD, c = i % NXD / CW, j = i % CW;
          if (c < len && j < nch)
            cp_async4(st + (which * T + c) * CW + j,
                      (which ? db : xb) + (long long)c * dim + j);
        }
      }
      constexpr int NBC = T * N / 4;  // B_t, C_t: len * N contiguous floats
      for (int i = lane; i < 2 * NBC; i += 32) {
        const int which = i / NBC, j = i % NBC;
        if (j < len * (N / 4))
          cp_async16(st + 2 * T * CW + which * T * N + 4 * j,
                     (which ? cm : bm) + (row + t0) * N + 4 * j);
      }
    }
    cp_async_commit();                 // empty groups keep the count
  };

  for (int ci = 0; ci < kStages - 1; ++ci) issue(ci);
  for (int ci = 0; ci < chunks; ++ci) {
    cp_async_wait<kStages - 2>();
    __syncwarp();        // chunk ci landed; the warp is done with ci - 1
    issue(ci + kStages - 1);
    const float* st = ring + (ci % kStages) * S::STAGE;
    const float* xs = st + col;
    const float* dts = xs + T * CW;
    const float* bs = st + 2 * T * CW + part * NPT;
    const float* cs = bs + T * N;
    const int t0 = ci * T, len = min(T, seq - t0);
    if (ckpt != nullptr && live && t0 % CKPT_EVERY == 0) {  // h before t0
      float* out = ckpt + (((long long)blockIdx.y * dim + d) *
                           ((seq + CKPT_EVERY - 1) / CKPT_EVERY) +
                           t0 / CKPT_EVERY) * N + part * NPT;
#pragma unroll
      for (int i = 0; i < NPT; ++i) out[i] = h[i];
    }
    // one step: the states advance, and y_t (in every lane of the channel)
    auto step = [&](int c) -> float {
      const float dtc = dts[c * CW], xc = xs[c * CW], dtx = dtc * xc;
      const float* bt = bs + c * N;
      const float* ct = cs + c * N;
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int g = 0; g < (NPT + 3) / 4; ++g) {
        float bv[4], cv[4];
        if constexpr (NPT >= 4) {
          const float4 bb = reinterpret_cast<const float4*>(bt)[g];
          const float4 cc = reinterpret_cast<const float4*>(ct)[g];
          bv[0] = bb.x, bv[1] = bb.y, bv[2] = bb.z, bv[3] = bb.w;
          cv[0] = cc.x, cv[1] = cc.y, cv[2] = cc.z, cv[3] = cc.w;
        } else if constexpr (NPT == 2) {
          const float2 bb = *reinterpret_cast<const float2*>(bt);
          const float2 cc = *reinterpret_cast<const float2*>(ct);
          bv[0] = bb.x, bv[1] = bb.y, cv[0] = cc.x, cv[1] = cc.y;
        } else {
          bv[0] = bt[0], cv[0] = ct[0];
        }
#pragma unroll
        for (int e = 0; e < cmin(4, NPT); ++e) {
          const int n = 4 * g + e;
          h[n] = fmaf(ex2(dtc * a2[n]), h[n], dtx * bv[e]);
          if (e & 1) acc1 = fmaf(h[n], cv[e], acc1);
          else acc0 = fmaf(h[n], cv[e], acc0);
        }
      }
      float sum = acc0 + acc1;
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      return fmaf(dskip, xc, sum);
    };
    float* yt = y + (row + t0) * dim + d;
    // dead channels run along (their lanes join the shuffles) unstored
    if (len == T) {
      float yv[T];
#pragma unroll
      for (int c = 0; c < T; ++c) yv[c] = step(c);
      if (live && part == 0) {
#pragma unroll
        for (int c = 0; c < T; ++c) yt[(long long)c * dim] = yv[c];
      }
    } else {
      for (int c = 0; c < len; ++c) {
        const float v = step(c);
        if (live && part == 0) yt[(long long)c * dim] = v;
      }
    }
    __syncwarp();        // the stage is read before it is refilled
  }
  if (live) {
    float* out = h_fin + ((long long)blockIdx.y * dim + d) * N + part * NPT;
#pragma unroll
    for (int i = 0; i < NPT; ++i) out[i] = h[i];
  }
}

template <int N, int L>
int launch(const float* x, const float* dt, const float* b, const float* c,
           const float* a, const float* d, float* y, float* h_fin,
           float* ckpt, int B, int S, int D, cudaStream_t stream) {
  using Tl = Tile<N, L>;
  dim3 grid((D + Tl::CH - 1) / Tl::CH, B);
  selective_scan_kernel<N, L><<<grid, kThreads, Tl::SMEM, stream>>>(
      x, dt, b, c, a, d, y, h_fin, ckpt, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// lanes: threads a channel (kernels/selective_scan.py plan); every (N,
// lanes) below is compiled, others return cudaErrorInvalidValue.  ckpt:
// null, or the [B, D, ceil(S / CKPT_EVERY), N] checkpoints.
extern "C" int selective_scan_f32(const void* x, const void* dt,
                                  const void* b, const void* c, const void* a,
                                  const void* d, void* y, void* h_fin,
                                  void* ckpt, int B, int S, int D, int N,
                                  int lanes, void* stream) {
  const float *xf = (const float*)x, *dtf = (const float*)dt,
              *bf = (const float*)b, *cf = (const float*)c,
              *af = (const float*)a, *df = (const float*)d;
  float *yf = (float*)y, *hf = (float*)h_fin, *kf = (float*)ckpt;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_N(NN, LL)                                                    \
  if (N == NN && lanes == LL)                                              \
    return launch<NN, LL>(xf, dtf, bf, cf, af, df, yf, hf, kf, B, S, D, s);
  REPRO_N(4, 1) REPRO_N(4, 2) REPRO_N(4, 4)
  REPRO_N(8, 1) REPRO_N(8, 2) REPRO_N(8, 4) REPRO_N(8, 8)
  REPRO_N(16, 2) REPRO_N(16, 4) REPRO_N(16, 8)
  REPRO_N(32, 4) REPRO_N(32, 8)
  REPRO_N(64, 8)
#undef REPRO_N
  return (int)cudaErrorInvalidValue;
}
