// RWKV-6 wkv recurrence for Hopper (sm_90a), from a zero initial state.
//
// Replaces the TPU kernel wkv_pallas (src/repro/kernels/wkv.py, body
// _wkv_kernel).  Per (batch, head), with state S [N, N]:
//   y_t[m] = sum_n r_t[n] * (S[n, m] + u[n] * k_t[n] * v_t[m])
//   S[n, m] = w_t[n] * S[n, m] + k_t[n] * v_t[m]
// Contract (all f32, contiguous):
//   r, k, v, w  [B, S, H, N]      u  [H, N]
//   y           [B, S, H, N]      s_fin  [B, H, N, N]  (S after the last step)
// The TPU kernel drops the final state; the prefill of the RWKV time mix
// needs it for the decode cache, so this kernel writes it.  S is any length:
// no padding is needed.
//
// What bounds it: each input element is read once and each output written
// once, ~5*N^2 flops per (b, t, h) against 5*4*N bytes, so at N = 64 it is
// about 16 flops per byte and bound by device-memory bytes (the H100's f32
// CUDA cores need ~20).  Design: one block per (head, batch) and one thread
// per state column m, which keeps its column S[:, m] in N registers for the
// whole sequence; the recurrence is serial in t, so the B*H blocks are the
// parallelism.  A chunk of C timesteps of r, k, v, w is staged in shared
// memory with coalesced loads, then the block runs C steps with no barrier.
// A chunked form on tensor cores is later work.
#include <cuda_runtime.h>

namespace {

template <int N>
__global__ void __launch_bounds__(N)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_fin, int seq, int heads) {
  constexpr int C = N >= 128 ? 16 : 32;   // timesteps staged per chunk
  __shared__ float rs[C][N], ks[C][N], vs[C][N], ws[C][N];
  __shared__ float us[N];
  const int h = blockIdx.x, b = blockIdx.y, m = threadIdx.x;
  const long long step = (long long)heads * N;          // one timestep
  const long long base = ((long long)b * seq * heads + h) * N;

  us[m] = u[h * N + m];
  float s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = 0.f;

  for (int t0 = 0; t0 < seq; t0 += C) {
    const int len = min(C, seq - t0);
    __syncthreads();                   // the previous chunk is consumed
    for (int c = 0; c < len; ++c) {
      const long long off = base + (t0 + c) * step + m;
      rs[c][m] = r[off];
      ks[c][m] = k[off];
      vs[c][m] = v[off];
      ws[c][m] = w[off];
    }
    __syncthreads();
    for (int c = 0; c < len; ++c) {
      const float vm = vs[c][m];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float kv = ks[c][n] * vm;
        acc = fmaf(rs[c][n], fmaf(us[n], kv, s[n]), acc);
        s[n] = fmaf(ws[c][n], s[n], kv);
      }
      y[base + (t0 + c) * step + m] = acc;
    }
  }
  float* out = s_fin + ((long long)b * heads + h) * N * N + m;
#pragma unroll
  for (int n = 0; n < N; ++n) out[n * N] = s[n];
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* y, float* s_fin, int B, int S, int H,
           cudaStream_t stream) {
  dim3 grid(H, B);
  wkv_kernel<N><<<grid, N, 0, stream>>>(r, k, v, w, u, y, s_fin, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wkv_f32(const void* r, const void* k, const void* v,
                       const void* w, const void* u, void* y, void* s_fin,
                       int B, int S, int H, int N, void* stream) {
  const float *rf = (const float*)r, *kf = (const float*)k,
              *vf = (const float*)v, *wf = (const float*)w,
              *uf = (const float*)u;
  float *yf = (float*)y, *sf = (float*)s_fin;
  cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
#define REPRO_N(NN) \
  case NN: return launch<NN>(rf, kf, vf, wf, uf, yf, sf, B, S, H, s);
    REPRO_N(8) REPRO_N(16) REPRO_N(32) REPRO_N(64) REPRO_N(128)
#undef REPRO_N
    default: return (int)cudaErrorInvalidValue;
  }
}
