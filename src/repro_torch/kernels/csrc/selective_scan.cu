// Mamba-1 selective scan for Hopper (sm_90a), from a zero initial state.
//
// Replaces the TPU kernel selective_scan_pallas (src/repro/kernels/
// selective_scan.py, body _selective_scan_kernel).  Per batch row b and
// channel d, with N states h[n]:
//   h[n]   = exp(dt_t * a[d, n]) * h[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h[n] * C_t[n] + D[d] * x_t
// Contract (all f32, contiguous):
//   x, dt [B, S, D]    b, c [B, S, N]    a [D, N]    d [D]
//   y     [B, S, D]    h_fin [B, D, N]   (h after the last step)
// The TPU kernel drops the final state; the Mamba prefill hands it to the
// decode cache, so this kernel writes it.  S and D are any size: no padding.
//
// What bounds it: x, dt and y are read or written once (12 bytes per (b, t,
// d)), against N exps and ~3N FMAs each, so at N = 16 it sits near the
// balance of the f32 units (SFU exps included) and device-memory bytes.
// Design: one thread per (b, d) channel keeps its N states and a[d, :] in
// registers for the whole sequence; the recurrence is serial in t and the
// B * D channels are the parallelism.  A block of 64 channels stages a chunk
// of timesteps of x and dt (coalesced over d) and of B_t and C_t (shared by
// all its channels) in shared memory, then runs the chunk with no barrier.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;     // channels per block
constexpr int kChunk = 32;       // timesteps staged per chunk

template <int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a, const float* __restrict__ dd,
                      float* __restrict__ y, float* __restrict__ h_fin,
                      int seq, int dim) {
  __shared__ float xs[kChunk][kThreads], dts[kChunk][kThreads];
  __shared__ float bs[kChunk][N], cs[kChunk][N];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const int b = blockIdx.y;
  const bool live = d < dim;

  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a[(long long)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dskip = live ? dd[d] : 0.f;
  const long long row = (long long)b * seq;          // first timestep of b

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int len = min(kChunk, seq - t0);
    __syncthreads();                   // the previous chunk is consumed
    if (live) {
      for (int c = 0; c < len; ++c) {
        const long long off = (row + t0 + c) * dim + d;
        xs[c][tid] = x[off];
        dts[c][tid] = dt[off];
      }
    }
    const float* bsrc = bm + (row + t0) * N;         // len * N contiguous
    const float* csrc = cm + (row + t0) * N;
    for (int i = tid; i < len * N; i += kThreads) {
      bs[i / N][i % N] = bsrc[i];
      cs[i / N][i % N] = csrc[i];
    }
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < len; ++c) {
      const float dtc = dts[c][tid], xc = xs[c][tid];
      const float dtx = dtc * xc;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = fmaf(expf(dtc * av[n]), h[n], dtx * bs[c][n]);
        acc = fmaf(h[n], cs[c][n], acc);
      }
      y[(row + t0 + c) * dim + d] = fmaf(dskip, xc, acc);
    }
  }
  if (live) {
    float* out = h_fin + ((long long)b * dim + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = h[n];
  }
}

template <int N>
int launch(const float* x, const float* dt, const float* b, const float* c,
           const float* a, const float* d, float* y, float* h_fin, int B,
           int S, int D, cudaStream_t stream) {
  dim3 grid((D + kThreads - 1) / kThreads, B);
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      x, dt, b, c, a, d, y, h_fin, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_f32(const void* x, const void* dt,
                                  const void* b, const void* c, const void* a,
                                  const void* d, void* y, void* h_fin, int B,
                                  int S, int D, int N, void* stream) {
  const float *xf = (const float*)x, *dtf = (const float*)dt,
              *bf = (const float*)b, *cf = (const float*)c,
              *af = (const float*)a, *df = (const float*)d;
  float *yf = (float*)y, *hf = (float*)h_fin;
  cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
#define REPRO_N(NN) \
  case NN: return launch<NN>(xf, dtf, bf, cf, af, df, yf, hf, B, S, D, s);
    REPRO_N(4) REPRO_N(8) REPRO_N(16) REPRO_N(32) REPRO_N(64)
#undef REPRO_N
    default: return (int)cudaErrorInvalidValue;
  }
}
