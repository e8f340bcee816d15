// Backward of the RWKV-6 wkv recurrence for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// the time mix's scan (src/repro/models/rwkv.py, _wkv_chunk_scan under
// jax.grad).  It is the gradient of csrc/wkv.cu.  Per (batch, head), with
// S_t = diag(w_t) S_{t-1} + k_t v_t^T and y_t = r_t^T (S_{t-1} + diag(u)
// k_t v_t^T), walking t backward with dS (the gradient of S_t):
//   G      = dS + (r_t o u) dy_t^T
//   dr_t   = (S_{t-1} + diag(u) k_t v_t^T) dy_t
//   dk_t   = G v_t                 dv_t = G^T k_t
//   dw_t   = rowsum(dS o S_{t-1})  du  += r_t o k_t (dy_t . v_t)
//   dS    <- diag(w_t) dS + r_t dy_t^T
// starting from the final state's gradient (ds_fin, or zero).
// Contract (all f32, contiguous):
//   r, k, v, w, dy  [B, S, H, N]     u  [H, N]
//   ckpt  [B, H, ceil(S / CKPT_EVERY), N, N]  the forward's states before
//         steps 0, CKPT_EVERY, ... (csrc/wkv.cu, given a ckpt pointer)
//   ds_fin [B, H, N, N] or null
//   dr, dk, dv, dw  [B, S, H, N]     du_part [B, H, N]  (du of each batch
//         row; the wrapper sums them over B in a fixed order)
// No floating-point atomics: every output element has one writer, so two
// runs give the same bits.
//
// What bounds it: each input and output element moves once (9 tensors of
// [B, S, H, N] and the checkpoints), against ~14 f32 operations per state
// element and step; at N = 64 that is ~25 per byte, so the f32 units bound
// it, and in practice the serial chain in t and the exchanges between
// threads.
//
// Design:
// * One block per (b, h); a thread keeps one row n and COLS adjacent
//   columns of S and of dS in registers (N * N / COLS threads).  The row
//   sums (dr, dk, dw, dy . v) meet over the N / COLS threads of a row by
//   xor shuffles; the column sums (dv) meet over a warp's rows by
//   shuffles, then over the warps in shared memory, in warp order.
// * S_{t-1} is needed while t runs backward.  The chunk of CKPT_EVERY steps
//   is replayed forward from its checkpoint, keeping the state at the start
//   of each sub-chunk of T steps in shared memory (each thread its own
//   words); each sub-chunk, last first, is then replayed from there with its
//   T states in registers and walked back.  The replay repeats the
//   forward's arithmetic, so the states are the forward's.
#include <cuda_runtime.h>

namespace {

constexpr int CKPT_EVERY = 64;       // csrc/wkv.cu, kernels/wkv.py
constexpr int COLS = 8;              // state columns a thread keeps
constexpr int T = 8;                 // steps a sub-chunk (states in registers)
constexpr int SUBS = CKPT_EVERY / T;

template <int N>
struct Shape {
  static constexpr int G = N / COLS;             // threads a row
  static constexpr int THREADS = N * G;
  static constexpr int WARPS = (THREADS + 31) / 32;
  // shared memory: sub-chunk states [SUBS][COLS][THREADS], dv partials
  // [WARPS][T][N]
  static constexpr int SMEM = 4 * (SUBS * COLS * THREADS + WARPS * T * N);
  static_assert(THREADS <= 1024, "one block a head");
};

__device__ __forceinline__ void load8(float (&dst)[COLS], const float* src) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  dst[0] = a.x, dst[1] = a.y, dst[2] = a.z, dst[3] = a.w;
  dst[4] = b.x, dst[5] = b.y, dst[6] = b.z, dst[7] = b.w;
}

template <int N>
__global__ void __launch_bounds__(Shape<N>::THREADS)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ dy,
               const float* __restrict__ ckpt,
               const float* __restrict__ ds_fin, float* __restrict__ dr,
               float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ du_part, int seq,
               int heads) {
  using Sh = Shape<N>;
  constexpr int G = Sh::G, THREADS = Sh::THREADS, WARPS = Sh::WARPS;
  extern __shared__ float4 smem4[];
  float* sub = reinterpret_cast<float*>(smem4);  // [SUBS][COLS][THREADS]
  float* colp = sub + SUBS * COLS * THREADS;      // [WARPS][T][N]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int n = tid / G, cg = tid % G, m0 = cg * COLS;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned mask = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1;
  const long long step = (long long)heads * N;
  const long long base = ((long long)b * seq * heads + h) * N;
  const int nchk = (seq + CKPT_EVERY - 1) / CKPT_EVERY;
  const long long bh = (long long)b * heads + h;
  const float un = u[h * N + n];

  float ds[COLS];
  if (ds_fin != nullptr) {
    load8(ds, ds_fin + (bh * N + n) * N + m0);
  } else {
#pragma unroll
    for (int e = 0; e < COLS; ++e) ds[e] = 0.f;
  }
  float du_acc = 0.f;

  for (int j = nchk - 1; j >= 0; --j) {
    const int t0 = j * CKPT_EVERY, len = min(CKPT_EVERY, seq - t0);
    const int nsub = (len + T - 1) / T;
    // the chunk replayed from its checkpoint: the state at each sub-chunk
    float s[COLS];
    load8(s, ckpt + ((bh * nchk + j) * N + n) * N + m0);
    for (int i = 0; i < nsub; ++i) {
#pragma unroll
      for (int e = 0; e < COLS; ++e) sub[(i * COLS + e) * THREADS + tid] = s[e];
      if (i == nsub - 1) break;
#pragma unroll
      for (int c = 0; c < T; ++c) {              // a whole sub-chunk
        const long long o = base + (long long)(t0 + i * T + c) * step;
        const float kn = __ldg(k + o + n), wn = __ldg(w + o + n);
        float vm[COLS];
        load8(vm, v + o + m0);
#pragma unroll
        for (int e = 0; e < COLS; ++e) s[e] = fmaf(wn, s[e], kn * vm[e]);
      }
    }
    for (int i = nsub - 1; i >= 0; --i) {
      const int ts = t0 + i * T, sl = min(T, seq - ts);
      float hist[T][COLS];                       // S_{t-1}, t = ts + c
#pragma unroll
      for (int e = 0; e < COLS; ++e) s[e] = sub[(i * COLS + e) * THREADS + tid];
#pragma unroll
      for (int c = 0; c < T; ++c) {
#pragma unroll
        for (int e = 0; e < COLS; ++e) hist[c][e] = s[e];
        if (c + 1 < sl) {
          const long long o = base + (long long)(ts + c) * step;
          const float kn = __ldg(k + o + n), wn = __ldg(w + o + n);
          float vm[COLS];
          load8(vm, v + o + m0);
#pragma unroll
          for (int e = 0; e < COLS; ++e) s[e] = fmaf(wn, s[e], kn * vm[e]);
        }
      }
#pragma unroll
      for (int c = T - 1; c >= 0; --c) {
        if (c >= sl) continue;                   // the same in every thread
        const long long o = base + (long long)(ts + c) * step;
        const float rn = __ldg(r + o + n), kn = __ldg(k + o + n),
                    wn = __ldg(w + o + n);
        float vm[COLS], dym[COLS], pv[COLS];
        load8(vm, v + o + m0);
        load8(dym, dy + o + m0);
        const float ru = rn * un, uk = un * kn;
        float pr = 0.f, pk = 0.f, pw = 0.f, pd = 0.f;
#pragma unroll
        for (int e = 0; e < COLS; ++e) {
          const float sp = hist[c][e];
          const float g = fmaf(ru, dym[e], ds[e]);
          pr = fmaf(fmaf(uk, vm[e], sp), dym[e], pr);
          pk = fmaf(g, vm[e], pk);
          pw = fmaf(ds[e], sp, pw);
          pd = fmaf(dym[e], vm[e], pd);
          pv[e] = g * kn;
          ds[e] = fmaf(wn, ds[e], rn * dym[e]);
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {   // over the row
          pr += __shfl_xor_sync(mask, pr, off);
          pk += __shfl_xor_sync(mask, pk, off);
          pw += __shfl_xor_sync(mask, pw, off);
          pd += __shfl_xor_sync(mask, pd, off);
        }
        if (cg == 0) {
          dr[o + n] = pr;
          dk[o + n] = pk;
          dw[o + n] = pw;
          du_acc = fmaf(rn * kn, pd, du_acc);
        }
#pragma unroll
        for (int off = G; off < 32 && off < THREADS; off <<= 1)  // warp rows
#pragma unroll
          for (int e = 0; e < COLS; ++e)
            pv[e] += __shfl_xor_sync(mask, pv[e], off);
        if (lane < G) {
          float* dst = colp + (warp * T + c) * N + m0;
          *reinterpret_cast<float4*>(dst) =
              make_float4(pv[0], pv[1], pv[2], pv[3]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(pv[4], pv[5], pv[6], pv[7]);
        }
      }
      __syncthreads();
      for (int e = tid; e < sl * N; e += THREADS) {   // dv, warps in order
        const int c = e / N, m = e % N;
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) a += colp[(q * T + c) * N + m];
        dv[base + (long long)(ts + c) * step + m] = a;
      }
      __syncthreads();
    }
  }
  if (cg == 0) du_part[bh * N + n] = du_acc;
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* dy, const float* ckpt,
           const float* ds_fin, float* dr, float* dk, float* dv, float* dw,
           float* du_part, int B, int S, int H, cudaStream_t stream) {
  using Sh = Shape<N>;
  cudaError_t e = cudaFuncSetAttribute(
      wkv_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B);
  wkv_bwd_kernel<N><<<grid, Sh::THREADS, Sh::SMEM, stream>>>(
      r, k, v, w, u, dy, ckpt, ds_fin, dr, dk, dv, dw, du_part, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// ds_fin may be null (the final state's gradient is zero); N in 8, 16, 32,
// 64 (kernels/wkv.py BWD_HEAD_SIZES), others return cudaErrorInvalidValue.
extern "C" int wkv_bwd_f32(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* dy,
                           const void* ckpt, const void* ds_fin, void* dr,
                           void* dk, void* dv, void* dw, void* du_part, int B,
                           int S, int H, int N, void* stream) {
  const float *rf = (const float*)r, *kf = (const float*)k,
              *vf = (const float*)v, *wf = (const float*)w,
              *uf = (const float*)u, *dyf = (const float*)dy,
              *cf = (const float*)ckpt, *sf = (const float*)ds_fin;
  float *drf = (float*)dr, *dkf = (float*)dk, *dvf = (float*)dv,
        *dwf = (float*)dw, *duf = (float*)du_part;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_BWD(NN)                                                      \
  if (N == NN)                                                             \
    return launch<NN>(rf, kf, vf, wf, uf, dyf, cf, sf, drf, dkf, dvf, dwf, \
                      duf, B, S, H, s);
  REPRO_BWD(8) REPRO_BWD(16) REPRO_BWD(32) REPRO_BWD(64)
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}
