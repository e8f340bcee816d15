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
// no padding is needed.  For training, given a ckpt pointer, it also writes
// the state before every CKPT_EVERY-th step, ckpt [B, H, ceil(S /
// CKPT_EVERY), N, N], from which csrc/wkv_bwd.cu recomputes the states it
// walks back through; inference passes null.
//
// What bounds it: each input element is read once and each output written
// once (5*4*N bytes per (b, t, h)) against 3 f32 instructions per (n, m) of
// the loop below: at N = 64 that is ~10 per byte, so it is bound by bytes
// and by the latency of the serial chain in t.  r_t, k_t and w_t are read
// from shared memory by every thread of a (b, h), so the fewer threads
// share a word, the fewer reads a step costs.
//
// Design:
// * The u-bonus is rank one in m: y_t[m] = r_t . S[:, m] + v_t[m] * bonus_t,
//   bonus_t = (r_t o u) . k_t, computed once per (b, t, h) when its chunk
//   has landed.  Per (n, m) the loop is then acc = fma(r, s, acc), kv = k*v,
//   s = fma(w, s, kv).
// * A thread keeps a COLS x NPT tile of the state in registers: rows n of
//   its part (N / NPT parts split each column) by COLS = 4 adjacent
//   columns, so each r, k, w word it reads from shared memory serves 4
//   columns (a thread per column was slower).  Column groups are the fast
//   thread index, so a warp's reads of r, k and w touch one or two parts'
//   rows.  Each column's acc runs as 2 independent sums; the parts'
//   partial y go to shared memory, and after each chunk the block adds
//   them in part order, with the bonus, into y.
// * Grid (H, B, msplit): msplit blocks share a (b, h), each with N/msplit
//   columns, where B*H alone does not fill the card.  NPT and msplit come
//   from the wrapper's plan.
// * Chunks of C timesteps of r, k, v, w go through a STAGES-deep ring of
//   16-byte cp.async copies, so the next STAGES-1 chunks load while one
//   runs.
// Variants tried on the H100 at the RWKV-6 shape (B 8, S 128, H 40, N 64):
// 4 to 6 ring stages, chunks of 8 or 16 steps and unrolling the step loop
// moved it by a few percent; wider tiles (COLS 8), steps prefetched into
// registers and columns split over more blocks made it slower.  Loading
// alone takes under half of its time; the rest is the step loop, held by
// instruction issue and latency with ~10 warps an SM.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 512;     // kernels/wkv.py MAX_THREADS
constexpr int CKPT_EVERY = 64;       // kernels/wkv.py CKPT_EVERY

__device__ inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

constexpr int COLS = 4;              // state columns a thread keeps

constexpr int STAGES = 6;            // chunks in the ring

template <int N>
__host__ __device__ constexpr int chunk() {
  return 512 / N;                    // timesteps a chunk: 8 KB a stage
}
static_assert(CKPT_EVERY % chunk<8>() == 0, "checkpoints on chunk starts");

// dynamic shared memory: the ring, u, the chunk's bonus, partial y
template <int N>
__host__ __device__ constexpr int smem_bytes(int threads) {
  return 4 * (STAGES * 4 * chunk<N>() * N + N + chunk<N>() +
              chunk<N>() * COLS * threads);
}

template <int N, int NPT>
__global__ void __launch_bounds__(MAX_THREADS)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_fin, float* __restrict__ ckpt, int seq,
           int heads, int cpb) {
  constexpr int PARTS = N / NPT;
  constexpr int C = chunk<N>();
  constexpr int Q = NPT / 4;         // float4 groups a thread reads a row
  constexpr int V4 = N / 4;          // float4 groups in a row
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [STAGES][4][C][N] r,k,v,w
  float* us = ring + STAGES * 4 * C * N;             // [N]
  float* bon = us + N;                               // [C]
  float* yp = bon + C;                               // [PARTS][C][cpb]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int groups_m = cpb / COLS;                   // column groups a block
  const int cg = tid % groups_m, part = tid / groups_m;
  const int m0 = blockIdx.z * cpb + COLS * cg;       // the thread's columns
  const int lg_cpb = __ffs(cpb) - 1;                 // cpb is a power of two
  const unsigned mask = nthreads >= 32 ? 0xffffffffu : (1u << nthreads) - 1;
  const long long step = (long long)heads * N;        // one timestep
  const long long base = ((long long)b * seq * heads + h) * N;
  const int chunks = (seq + C - 1) / C;
  auto row = [&](int buf, int a, int c) {
    return ring + ((buf * 4 + a) * C + c) * N;
  };

  for (int i = tid; i < N; i += nthreads) us[i] = u[h * N + i];
  float s[NPT][COLS];
#pragma unroll
  for (int i = 0; i < NPT; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
  // the thread's tile of the state into an [N, N] matrix at dst
  auto store_state = [&](float* dst) {
    float* out = dst + m0;
#pragma unroll
    for (int i = 0; i < NPT; ++i)
#pragma unroll
      for (int j = 0; j < COLS; j += 4)
        *reinterpret_cast<float4*>(out + (part * NPT + i) * N + j) =
            make_float4(s[i][j], s[i][j + 1], s[i][j + 2], s[i][j + 3]);
  };

  auto issue = [&](int ci) {          // chunk ci into its ring slot
    if (ci < chunks) {
      const int t0 = ci * C, len = min(C, seq - t0);
      for (int i = tid; i < 4 * C * V4; i += nthreads) {
        const int a = i / (C * V4), c = i / V4 % C, j = i % V4;
        const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? v : w;
        if (c < len)
          cp_async16(row(ci % STAGES, a, c) + 4 * j,
                     src + base + (t0 + c) * step + 4 * j);
      }
    }
    cp_async_commit();                 // empty groups keep the count
  };

  // threads per timestep of the bonus: a power of two, at most a warp;
  // thread tid sums rows bn, bn + tps, ... of timestep c0 + bc
  const int tps = max(1, min(32, nthreads / C));
  const int groups = nthreads / tps;
  const int bc = tid / tps, bn = tid & (tps - 1);

  for (int ci = 0; ci < STAGES - 1; ++ci) issue(ci);
  for (int ci = 0; ci < chunks; ++ci) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();     // chunk ci landed; chunk ci-1 is fully consumed
    issue(ci + STAGES - 1);
    const int cur = ci % STAGES, t0 = ci * C, len = min(C, seq - t0);
    if (ckpt != nullptr && t0 % CKPT_EVERY == 0)    // the state before t0
      store_state(ckpt + (((long long)b * heads + h) *
                          ((seq + CKPT_EVERY - 1) / CKPT_EVERY) +
                          t0 / CKPT_EVERY) * N * N);
    for (int c0 = 0; c0 < C; c0 += groups) {           // bonus_t, t in chunk
      const int c = c0 + bc;
      float a = 0.f;
      if (c < len) {
        const float *rc = row(cur, 0, c), *kc = row(cur, 1, c);
        for (int n = bn; n < N; n += tps) a = fmaf(rc[n] * us[n], kc[n], a);
      }
      for (int o = tps / 2; o > 0; o >>= 1) a += __shfl_xor_sync(mask, a, o);
      if (c < len && bn == 0) bon[c] = a;
    }
#pragma unroll 2
    for (int c = 0; c < len; ++c) {           // the steps need no bonus
      const float4* r4 = reinterpret_cast<const float4*>(row(cur, 0, c));
      const float4* k4 = reinterpret_cast<const float4*>(row(cur, 1, c));
      const float4* w4 = reinterpret_cast<const float4*>(row(cur, 3, c));
      float vm[COLS];
#pragma unroll
      for (int j = 0; j < COLS; j += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(row(cur, 2, c) + m0 + j);
        vm[j] = v4.x, vm[j + 1] = v4.y, vm[j + 2] = v4.z, vm[j + 3] = v4.w;
      }
      float acc[COLS][2];
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[j][0] = acc[j][1] = 0.f;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int g = part * Q + i;                    // rows 4g .. 4g+3
        const float4 rr = r4[g], kk = k4[g], ww = w4[g];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            float& st = s[4 * i + e][j];
            acc[j][e & 1] = fmaf(rv[e], st, acc[j][e & 1]);
            st = fmaf(wv[e], st, kv[e] * vm[j]);
          }
      }
      float* dst = yp + (part * C + c) * cpb + COLS * cg;
#pragma unroll
      for (int j = 0; j < COLS; j += 4)
        *reinterpret_cast<float4*>(dst + j) = make_float4(
            acc[j][0] + acc[j][1], acc[j + 1][0] + acc[j + 1][1],
            acc[j + 2][0] + acc[j + 2][1], acc[j + 3][0] + acc[j + 3][1]);
    }
    __syncthreads();
    for (int e = tid; e < len * cpb; e += nthreads) {  // y, parts in order
      const int c = e >> lg_cpb, col = e & (cpb - 1);
      float a = 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) a += yp[(p * C + c) * cpb + col];
      const int mm = blockIdx.z * cpb + col;
      y[base + (t0 + c) * step + mm] = fmaf(row(cur, 2, c)[mm], bon[c], a);
    }
  }
  store_state(s_fin + ((long long)b * heads + h) * N * N);
}

template <int N, int NPT>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* y, float* s_fin, float* ckpt, int B, int S,
           int H, int msplit, cudaStream_t stream) {
  if (msplit < 1 || N % (msplit * COLS) ||
      (N / msplit / COLS) * (N / NPT) > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const int cpb = N / msplit, threads = cpb / COLS * (N / NPT);
  const int smem = smem_bytes<N>(threads);
  cudaError_t e = cudaFuncSetAttribute(
      wkv_kernel<N, NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, msplit);
  wkv_kernel<N, NPT><<<grid, threads, smem, stream>>>(r, k, v, w, u, y,
                                                      s_fin, ckpt, S, H, cpb);
  return (int)cudaGetLastError();
}

}  // namespace

// npt: state rows per thread (4 or 8, at most N); msplit: blocks per
// (b, h), each with N / msplit columns (kernels/wkv.py plan); ckpt: null,
// or the [B, H, ceil(S / CKPT_EVERY), N, N] checkpoints.
extern "C" int wkv_f32(const void* r, const void* k, const void* v,
                       const void* w, const void* u, void* y, void* s_fin,
                       void* ckpt, int B, int S, int H, int N, int npt,
                       int msplit, void* stream) {
  const float *rf = (const float*)r, *kf = (const float*)k,
              *vf = (const float*)v, *wf = (const float*)w,
              *uf = (const float*)u;
  float *yf = (float*)y, *sf = (float*)s_fin, *cf = (float*)ckpt;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_N(NN, PT)                                                  \
  if (N == NN && npt == PT)                                              \
    return launch<NN, PT>(rf, kf, vf, wf, uf, yf, sf, cf, B, S, H, msplit, \
                          s);
  REPRO_N(8, 4) REPRO_N(8, 8) REPRO_N(16, 4) REPRO_N(16, 8)
  REPRO_N(32, 4) REPRO_N(32, 8) REPRO_N(64, 4) REPRO_N(64, 8)
  REPRO_N(128, 4) REPRO_N(128, 8)
#undef REPRO_N
  return (int)cudaErrorInvalidValue;
}
