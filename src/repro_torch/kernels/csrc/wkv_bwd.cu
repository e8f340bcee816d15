// Backward of the RWKV-6 wkv recurrence for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// the time mix's scan (src/repro/models/rwkv.py, _wkv_chunk_scan under
// jax.grad).  It is the gradient of csrc/wkv.cu.  Per (batch, head), with
// S_t = diag(w_t) S_{t-1} + k_t v_t^T and y_t = r_t^T (S_{t-1} + diag(u)
// k_t v_t^T), walking t backward with dS (the gradient of S_t), and with
// D_t = dy_t . v_t and E_t = sum_n r_t u k_t:
//   dr_t   = S_{t-1} dy_t + u o k_t D_t
//   dk_t   = dS v_t + r_t o u D_t      dv_t = dS^T k_t + dy_t E_t
//   dw_t   = rowsum(dS o S_{t-1})      du  += r_t o k_t D_t
//   dS    <- diag(w_t) dS + r_t dy_t^T
// starting from the final state's gradient (ds_fin, or zero).
// Contract (all f32, contiguous):
//   r, k, v, w, dy  [B, S, H, N]     u  [H, N]
//   ckpt  [B, H, ceil(S / CKPT_EVERY), N, N]  the forward's states before
//         steps 0, CKPT_EVERY, ... (csrc/wkv.cu, given a ckpt pointer)
//   ds_fin [B, H, N, N] or null
//   xs    [B, H, ceil(S / CKPT_EVERY), N, N] scratch (null when S <=
//         CKPT_EVERY): dS entering each chunk's walk
//   dr, dk, dv, dw  [B, S, H, N]
//   du_part [B, H, ceil(S / CKPT_EVERY), N]  (du of each batch row and
//         chunk; the wrapper sums them in a fixed order)
// No floating-point atomics: every output element has one writer and every
// sum runs in a fixed order, so two runs give the same bits.
//
// What bounds it: each input and output element moves once (9 tensors of
// [B, S, H, N] and the checkpoints), against ~14 f32 operations per state
// element and step; at N = 64 that is ~25 per byte, so the f32 units bound
// it (0.561 ms at the RWKV-6 3B training layer, B 4, S 4096, H 40).  The
// first design (one block of 512 threads a (b, h)) ran at 18.8x that bound:
// its 160 blocks ran as two waves on 132 SMs, every step did 28 shuffles a
// thread for the row and column sums, and every step's inputs came from
// global memory.  This one runs at ~7.1x (3.99 ms on an H100 80GB HBM3 at
// 700 W, PERF.md); what is left is latency between the threads of a
// cluster, not arithmetic.  Removing parts in turn on that card
// (scripts/bwd_ablations.py, 4.00 ms whole): the dS carry takes 0.57 ms;
// the walk is 0.52 ms shorter without its two replays, 0.48 without the
// staging copies (each CTA reads all N rows of r, k, w), 0.32 without dv's
// reduce-scatter, 0.24 without the per-sub-chunk epilogue and 0.24 without
// the cluster barriers and their DSMEM reads.
//
// Design:
// * A sequence split at the forward's checkpoints.  Only dS crosses
//   chunks, and each column of dS follows its own linear recurrence, so a
//   first kernel (wkv_bwd_carry_kernel: tiles of 32 rows by 32 columns, a
//   row by 8 columns a thread, stages of 32 steps) walks dS alone back over
//   the sequence, two operations an element and step, and writes the dS
//   entering each chunk to xs.  Its fmas are the walk's, so xs holds the
//   bits a single walk would reach.  The walk proper (wkv_bwd_chunk_kernel)
//   then runs every (b, h, chunk) at once: 10,240 clusters at the training
//   layer, which fill the card in balanced waves.
// * Each chunk's state columns are split over a cluster of CL CTAs, MC
//   columns each (2 CTAs of 32 at N 64; 16 columns at N 16 and 32); a
//   thread keeps one row and 8 columns of S and dS in registers (256
//   threads a CTA at N 64).  Only the row sums (dr, dk, dw and dy . v)
//   cross columns: each thread keeps its per-step partials in registers
//   through a sub-chunk of T = 8 steps, a reduce-scatter over the row's
//   G = MC / 8 threads (each round halves the values a lane holds) sums
//   them over the CTA's columns, and they go to the CTA's shared memory.
//   After a cluster barrier each CTA sums its share of the rows over the
//   CTAs in rank order through distributed shared memory (map_shared_rank)
//   and writes them.  One split barrier a sub-chunk (arrive after the
//   writes, wait before the reads; dv's sums run between): the partials
//   alternate between two buffers, so a buffer's next writer comes after
//   the next sub-chunk's barrier, which every reader of it has passed.  dv
//   stays inside a CTA:
//   per step a reduce-scatter over the warp's rows, then the warps in order
//   through shared memory.  The u-bonus terms are rank one and added once
//   per output, not per element.
// * S_{t-1} is needed while t runs backward: the chunk is replayed forward
//   from its checkpoint, keeping the state at each sub-chunk start in shared
//   memory (each thread its own words), then each sub-chunk, last first, is
//   replayed from there with its T states in registers and walked back.  The
//   replay is the forward's fmaf(w, s, k * v), so the states are its bits.
//   A whole sub-chunk and the ragged last one are compiled apart, so the
//   steps of a whole one carry no tests between them.
// * Each sub-chunk's r, k, w (all N rows) and v, dy (the CTA's columns) go
//   through a two-stage cp.async ring in shared memory, one sub-chunk ahead
//   of use (the forward replay stages k, w and v only); the carry kernel
//   stages its r, w, dy through a three-stage ring the same way.
// Occupancy at N 64: 256 threads, at most 128 registers (launch bounds) and
// 92.3 KiB of shared memory a CTA, so 2 CTAs (one cluster) an SM, 16 warps;
// cudaOccupancyMaxActiveClusters (wkv_bwd_clusters) gives 132 resident
// clusters at the training layer's launch on an H100.  The carry: 128
// threads, 36 KiB a CTA, 640 CTAs at the training layer, all resident.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int CKPT_EVERY = 64;       // csrc/wkv.cu, kernels/wkv.py
constexpr int COLS = 8;              // state columns a thread keeps
constexpr int T = 8;                 // steps a sub-chunk (states in registers)
constexpr int SUBS = CKPT_EVERY / T;

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// The walk of one chunk: a cluster of CL CTAs, MC columns each.
template <int N>
struct Walk {
  // columns a CTA: 32 at N 64 (four CTAs of 16 took 27% longer on an H100
  // at the RWKV-6 3B training layer, scripts/bwd_ablations.py), 16 at N 16
  // and 32, all at 8
  static constexpr int MC = N >= 64 ? 32 : (N >= 16 ? 16 : N);
  static constexpr int CL = N / MC;              // CTAs a cluster
  static constexpr int G = MC / COLS;            // threads a row
  static constexpr int THREADS = N * G;
  static constexpr int WARPS = (THREADS + 31) / 32;
  static constexpr int LANES = THREADS < 32 ? THREADS : 32;
  static constexpr int LOGR = ilog2(LANES / G);  // rounds over a warp's rows
  static constexpr int KEEP = (COLS >> LOGR) > 0 ? (COLS >> LOGR) : 1;
  static constexpr int NR = N / CL;              // rows a CTA writes
  static constexpr int STAGE = T * (3 * N + 2 * MC);  // r, k, w; v, dy
  // CTAs an SM the launch bounds leave registers for (128 a thread)
  static constexpr int MIN_BLOCKS = 512 / THREADS < 32 ? 512 / THREADS : 32;
  // shared floats: the ring, sub-chunk states, row partials and dy . v
  // partials (two sub-chunks each), dv partials (then du), E, u
  static constexpr int SMEM_FLOATS = 2 * STAGE + (SUBS - 1) * COLS * THREADS +
                                     2 * 3 * T * N + WARPS * T * MC + 2 * T +
                                     T + N;
  static constexpr int SMEM = 4 * SMEM_FLOATS;
  static_assert(THREADS >= T && THREADS >= NR, "a thread a step and a row");
  static_assert(WARPS * MC >= NR, "du of each (step, row) fits colp");
};

// The dS carry over the chunks: tiles of NRT rows by MC columns, a row by
// 8 columns a thread, RING stages of TC steps (its steps are short, so long
// stages keep its loads far enough ahead).
constexpr int TC = 32;
constexpr int CPT = CKPT_EVERY / TC;   // carry stages a chunk
template <int N>
struct Carry {
  static constexpr int MC = N >= 32 ? 32 : N;
  static constexpr int NRT = MC;
  static constexpr int G = MC / COLS;
  static constexpr int THREADS = NRT * G;
  static constexpr int TILES = (N / MC) * (N / NRT);
  static constexpr int RING = 3;
  static constexpr int STAGE = TC * (2 * NRT + MC);  // r, w; dy
  static constexpr int SMEM = 4 * RING * STAGE;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void load8(float (&dst)[COLS], const float* src) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  dst[0] = a.x, dst[1] = a.y, dst[2] = a.z, dst[3] = a.w;
  dst[4] = b.x, dst[5] = b.y, dst[6] = b.z, dst[7] = b.w;
}
__device__ __forceinline__ void lds8(float (&dst)[COLS], const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x, dst[1] = a.y, dst[2] = a.z, dst[3] = a.w;
  dst[4] = b.x, dst[5] = b.y, dst[6] = b.z, dst[7] = b.w;
}
__device__ __forceinline__ void store8(float* dst, const float (&src)[COLS]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(src[4], src[5], src[6],
                                                  src[7]);
}

// The V values of every lane summed over the lanes ``l << k`` apart, k <
// LOGR: each round halves what a lane holds (the upper or lower half by its
// bit k), or, once one value is left, adds it across.  ``idx`` accumulates
// the index of the lane's first kept value.
template <int H, int K, int LOGR>
struct Scatter {
  template <int V>
  __device__ __forceinline__ static void run(float (&v)[V], int lane, int l,
                                             int& idx, unsigned mask) {
    if constexpr (K < LOGR) {
      const int off = l << K;
      const bool hi = (lane & off) != 0;
      if constexpr (H > 1) {
        constexpr int HALF = H / 2;
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const float send = hi ? v[i] : v[i + HALF];
          const float keep = hi ? v[i + HALF] : v[i];
          v[i] = keep + __shfl_xor_sync(mask, send, off);
        }
        if (hi) idx += HALF;
        Scatter<HALF, K + 1, LOGR>::run(v, lane, l, idx, mask);
      } else {
        v[0] += __shfl_xor_sync(mask, v[0], off);
        Scatter<1, K + 1, LOGR>::run(v, lane, l, idx, mask);
      }
    }
  }
};

// dS walked back over chunks nchk-1 .. 1 alone; xs[b, h, j] = dS entering
// chunk j's walk (the gradient of the state after its last step).
template <int N>
__global__ void __launch_bounds__(Carry<N>::THREADS)
wkv_bwd_carry_kernel(const float* __restrict__ r, const float* __restrict__ w,
                     const float* __restrict__ dy,
                     const float* __restrict__ ds_fin, float* __restrict__ xs,
                     int seq, int heads) {
  using C = Carry<N>;
  constexpr int MC = C::MC, NRT = C::NRT, G = C::G, THREADS = C::THREADS;
  constexpr int RING = C::RING;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [RING][r, w; dy]

  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nb = blockIdx.x / (N / MC) * NRT;     // the tile's first row
  const int mb = blockIdx.x % (N / MC) * MC;      // and first column
  const int nl = tid / G, n = nb + nl, ml0 = (tid % G) * COLS;
  const long long step = (long long)heads * N;
  const long long base = ((long long)b * seq * heads + h) * N;
  const long long bh = (long long)b * heads + h;
  const int nchk = (seq + CKPT_EVERY - 1) / CKPT_EVERY;
  const int nsub = (seq + TC - 1) / TC;             // stages of the sequence
  const int items = nsub - CPT;                  // those after chunk 0

  float ds[COLS];
  if (ds_fin != nullptr) {
    load8(ds, ds_fin + (bh * N + n) * N + mb + ml0);
  } else {
#pragma unroll
    for (int e = 0; e < COLS; ++e) ds[e] = 0.f;
  }
  auto issue = [&](int q) {          // stage nsub - 1 - q
    if (q < items) {
      float* st = ring + (q % RING) * C::STAGE;
      const int ts = (nsub - 1 - q) * TC, sl = min(TC, seq - ts);
      constexpr int RQ = NRT / 4, CQ = MC / 4, PER = 2 * RQ + CQ;
      for (int e = tid; e < TC * PER; e += THREADS) {
        const int c = e / PER, x = e % PER;
        if (c >= sl) continue;
        const long long o = base + (long long)(ts + c) * step;
        if (x < 2 * RQ) {
          const int a = x / RQ, y = x % RQ;
          cp_async16(st + (a * TC + c) * NRT + 4 * y,
                     (a ? w : r) + o + nb + 4 * y);
        } else {
          const int y = x - 2 * RQ;
          cp_async16(st + 2 * TC * NRT + c * MC + 4 * y, dy + o + mb + 4 * y);
        }
      }
    }
    cp_async_commit();
  };
  auto store = [&](int j) {
    store8(xs + ((bh * nchk + j) * N + n) * N + mb + ml0, ds);
  };

  for (int q = 0; q < RING - 1; ++q) issue(q);
  for (int q = 0; q < items; ++q) {
    cp_async_wait<RING - 2>();
    __syncthreads();       // stage q landed; q - 1 is fully consumed
    issue(q + RING - 1);
    const int g = nsub - 1 - q, ts = g * TC, sl = min(TC, seq - ts);
    if (q == 0 || g % CPT == CPT - 1) store(g / CPT);
    const float* st = ring + (q % RING) * C::STAGE;
    auto walk = [&](auto whole) {      // compiled apart for a whole stage
      constexpr bool FULL = decltype(whole)::value;
#pragma unroll
      for (int c = TC - 1; c >= 0; --c) {
        if (!FULL && c >= sl) continue;          // the same in every thread
        const float rn = st[c * NRT + nl], wn = st[(TC + c) * NRT + nl];
        float dym[COLS];
        lds8(dym, st + 2 * TC * NRT + c * MC + ml0);
#pragma unroll
        for (int e = 0; e < COLS; ++e) ds[e] = fmaf(wn, ds[e], rn * dym[e]);
      }
    };
    if (sl == TC) {
      walk(std::true_type{});
    } else {
      walk(std::false_type{});
    }
  }
  store(0);
}

// The walk of chunk blockIdx.z of (b, h), columns split over the cluster.
template <int N>
__global__ void __launch_bounds__(Walk<N>::THREADS, Walk<N>::MIN_BLOCKS)
wkv_bwd_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ dy,
                     const float* __restrict__ ckpt,
                     const float* __restrict__ xs, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     int seq, int heads) {
  using W = Walk<N>;
  constexpr int MC = W::MC, CL = W::CL, G = W::G, THREADS = W::THREADS;
  constexpr int WARPS = W::WARPS, NR = W::NR, STAGE = W::STAGE;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [2][STAGE]
  float* subs = ring + 2 * STAGE;                 // [SUBS-1][COLS][THREADS]
  // row partials of two sub-chunks, [2][3][T][N]: a sub-chunk's partials
  // go to its parity's half, so the half is free again by the time the
  // next sub-chunk but one writes it (one cluster barrier a sub-chunk)
  float* xbuf = subs + (SUBS - 1) * COLS * THREADS;
  float* colp = xbuf + 2 * 3 * T * N;             // [WARPS][T][MC]
  float* dpart = colp + WARPS * T * MC;           // [2][T] dy . v, own columns
  float* esum = dpart + 2 * T;                    // [T] E_t
  float* us = esum + T;                           // [N] u

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x / CL, b = blockIdx.y, j = blockIdx.z;
  const int tid = threadIdx.x, n = tid / G, ml0 = (tid % G) * COLS;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned mask = THREADS >= 32 ? 0xffffffffu : (1u << THREADS) - 1;
  const long long step = (long long)heads * N;
  const long long base = ((long long)b * seq * heads + h) * N;
  const long long bh = (long long)b * heads + h;
  const int nchk = (seq + CKPT_EVERY - 1) / CKPT_EVERY;
  const int t0 = j * CKPT_EVERY, len = min(CKPT_EVERY, seq - t0);
  const int nsub = (len + T - 1) / T;
  const int items = 2 * nsub - 1;  // sub-chunks 0 .. nsub-2, then nsub-1 .. 0
  const long long cko = ((bh * nchk + j) * N + n) * N + rank * MC + ml0;
  auto sub_of = [&](int p) { return p < nsub - 1 ? p : 2 * nsub - 2 - p; };

  for (int i = tid; i < N; i += THREADS) us[i] = u[h * N + i];
  auto issue = [&](int p) {          // sub-chunk sub_of(p) into slot p % 2
    if (p < items) {
      float* st = ring + (p & 1) * STAGE;
      const int ts = t0 + sub_of(p) * T, sl = min(T, seq - ts);
      const bool fwd = p < nsub - 1;   // the replay reads k, w and v only
      constexpr int RQ = N / 4, CQ = MC / 4, PER = 3 * RQ + 2 * CQ;
      for (int e = tid; e < T * PER; e += THREADS) {
        const int c = e / PER, x = e % PER;
        if (c >= sl || (fwd && (x < RQ || x >= 3 * RQ + CQ))) continue;
        const long long o = base + (long long)(ts + c) * step;
        if (x < 3 * RQ) {
          const int a = x / RQ, y = x % RQ;
          const float* src = a == 0 ? r : a == 1 ? k : w;
          cp_async16(st + (a * T + c) * N + 4 * y, src + o + 4 * y);
        } else {
          const int a = (x - 3 * RQ) / CQ, y = (x - 3 * RQ) % CQ;
          cp_async16(st + 3 * T * N + (a * T + c) * MC + 4 * y,
                     (a ? dy : v) + o + rank * MC + 4 * y);
        }
      }
    }
    cp_async_commit();
  };

  float s[COLS], ds[COLS];
  load8(s, ckpt + cko);
  if (xs != nullptr) {
    load8(ds, xs + cko);
  } else {
#pragma unroll
    for (int e = 0; e < COLS; ++e) ds[e] = 0.f;
  }
  constexpr int PPT = (T * NR + THREADS - 1) / THREADS;  // (step, row) pairs
  float du_acc[PPT];                 // du of the thread's pairs
#pragma unroll
  for (int kk = 0; kk < PPT; ++kk) du_acc[kk] = 0.f;
  int par = 0;

  issue(0);
  for (int p = 0; p < items; ++p) {
    cp_async_wait<0>();
    __syncthreads();       // sub-chunk p landed; p - 1 is fully consumed
    issue(p + 1);
    const float* sr = ring + (p & 1) * STAGE;
    const float *sk = sr + T * N, *sw = sk + T * N, *sv = sw + T * N;
    const float* sdy = sv + T * MC;
    const int i = sub_of(p);
    if (p < nsub - 1) {                // pass 1: a whole sub-chunk forward
#pragma unroll
      for (int c = 0; c < T; ++c) {
        const float kn = sk[c * N + n], wn = sw[c * N + n];
        float vm[COLS];
        lds8(vm, sv + c * MC + ml0);
#pragma unroll
        for (int e = 0; e < COLS; ++e) s[e] = fmaf(wn, s[e], kn * vm[e]);
      }
#pragma unroll
      for (int e = 0; e < COLS; ++e)
        subs[(i * COLS + e) * THREADS + tid] = s[e];
      continue;
    }
    // pass 2: sub-chunk i replayed into registers and walked back
    const int ts = t0 + i * T, sl = min(T, seq - ts);
    {                                  // this CTA's dy . v, and E_t
      constexpr int TPS = THREADS / T;   // threads a step (adjacent lanes)
      const int c = tid / TPS, q0 = tid % TPS;
      float dp = 0.f, ee = 0.f;
      if (c < sl) {
#pragma unroll
        for (int m = q0; m < MC; m += TPS)
          dp = fmaf(sdy[c * MC + m], sv[c * MC + m], dp);
#pragma unroll
        for (int q = q0; q < N; q += TPS)
          ee = fmaf(sr[c * N + q] * us[q], sk[c * N + q], ee);
      }
#pragma unroll
      for (int o = TPS / 2; o > 0; o >>= 1) {
        dp += __shfl_xor_sync(mask, dp, o);
        ee += __shfl_xor_sync(mask, ee, o);
      }
      if (q0 == 0) dpart[par * T + c] = dp, esum[c] = ee;
    }
    if (i == 0) {
      load8(s, ckpt + cko);
    } else {
#pragma unroll
      for (int e = 0; e < COLS; ++e)
        s[e] = subs[((i - 1) * COLS + e) * THREADS + tid];
    }
    float rp[3 * T];                     // per step: S dy, dS v, rowsum(dS S)
    // the replay and the walk, compiled apart for a whole sub-chunk (no
    // step tests between the steps) and for the ragged last one
    auto walk = [&](auto whole) {
      constexpr bool FULL = decltype(whole)::value;
      float hist[T][COLS];               // S_{t-1}, t = ts + c
#pragma unroll
      for (int c = 0; c < T; ++c) {
#pragma unroll
        for (int e = 0; e < COLS; ++e) hist[c][e] = s[e];
        if (c + 1 < T && (FULL || c + 1 < sl)) {
          const float kn = sk[c * N + n], wn = sw[c * N + n];
          float vm[COLS];
          lds8(vm, sv + c * MC + ml0);
#pragma unroll
          for (int e = 0; e < COLS; ++e) s[e] = fmaf(wn, s[e], kn * vm[e]);
        }
      }
#pragma unroll
      for (int c = T - 1; c >= 0; --c) {
        if (!FULL && c >= sl) {          // the same in every thread
          rp[c] = rp[T + c] = rp[2 * T + c] = 0.f;
          continue;
        }
        const float rn = sr[c * N + n], kn = sk[c * N + n];
        const float wn = sw[c * N + n];
        float vm[COLS], dym[COLS], pv[COLS];
        lds8(vm, sv + c * MC + ml0);
        lds8(dym, sdy + c * MC + ml0);
        float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
        for (int e = 0; e < COLS; ++e) {
          const float sp = hist[c][e];
          pr = fmaf(sp, dym[e], pr);
          pk = fmaf(ds[e], vm[e], pk);
          pw = fmaf(ds[e], sp, pw);
          pv[e] = ds[e] * kn;
          ds[e] = fmaf(wn, ds[e], rn * dym[e]);
        }
        rp[c] = pr, rp[T + c] = pk, rp[2 * T + c] = pw;
        int idx = 0;                     // dv over the warp's rows
        Scatter<COLS, 0, W::LOGR>::run(pv, lane, G, idx, mask);
        float* dst = colp + (warp * T + c) * MC + ml0 + idx;
#pragma unroll
        for (int q = 0; q < W::KEEP; ++q) dst[q] = pv[q];  // duplicates alike
      }
    };
    if (sl == T) {
      walk(std::true_type{});
    } else {
      walk(std::false_type{});
    }
    // the row partials: halved over the row's G threads (a reduce-scatter)
    int rbase = 0;
    Scatter<3 * T, 0, ilog2(G)>::run(rp, lane, 1, rbase, mask);
    float* xb = xbuf + par * 3 * T * N;
#pragma unroll
    for (int q = 0; q < 3 * T / G; ++q) xb[(rbase + q) * N + n] = rp[q];
    cluster_arrive();                    // partials out (release)
    __syncthreads();
    for (int e = tid; e < sl * MC; e += THREADS) {   // dv, warps in order
      const int c = e / MC, ml = e % MC;
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) a += colp[(q * T + c) * MC + ml];
      dv[base + (long long)(ts + c) * step + rank * MC + ml] =
          fmaf(sdy[c * MC + ml], esum[c], a);
    }
    cluster_wait();                      // every CTA's partials in (acquire)
#pragma unroll
    for (int kk = 0; kk < PPT; ++kk) {   // the CTA's rows: (step, row) pairs
      const int pq = tid + kk * THREADS, c = pq / NR, nn = rank * NR + pq % NR;
      if (pq >= T * NR || c >= sl) continue;
      float dd = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int q = 0; q < CL; ++q) {     // D_t and the row sums, in rank order
        const float* xr = cluster.map_shared_rank(xb, q);
        dd += cluster.map_shared_rank(dpart, q)[par * T + c];
        a0 += xr[c * N + nn];
        a1 += xr[(T + c) * N + nn];
        a2 += xr[(2 * T + c) * N + nn];
      }
      const long long o = base + (long long)(ts + c) * step + nn;
      const float rn = sr[c * N + nn], kn = sk[c * N + nn];
      dr[o] = fmaf(us[nn] * kn, dd, a0);
      dk[o] = fmaf(rn * us[nn], dd, a1);
      dw[o] = a2;
      du_acc[kk] = fmaf(rn * kn, dd, du_acc[kk]);
    }
    par ^= 1;
  }
  cluster_arrive();        // no CTA leaves while another reads its memory
  cluster_wait();
  float* dus = colp;                 // du of each (step, row) pair, [T][NR]
#pragma unroll
  for (int kk = 0; kk < PPT; ++kk)
    if (tid + kk * THREADS < T * NR) dus[tid + kk * THREADS] = du_acc[kk];
  __syncthreads();
  if (tid < NR) {                    // the steps in order
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < T; ++c) a += dus[c * NR + tid];
    du_part[(bh * nchk + j) * N + rank * NR + tid] = a;
  }
}

template <int N>
cudaError_t walk_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                        int B, int S, int H, cudaStream_t stream) {
  using W = Walk<N>;
  cudaError_t e = cudaFuncSetAttribute(
      wkv_bwd_chunk_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W::SMEM);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(W::CL * H, B, (S + CKPT_EVERY - 1) / CKPT_EVERY);
  cfg.blockDim = dim3(W::THREADS);
  cfg.dynamicSmemBytes = W::SMEM;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = W::CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* dy, const float* ckpt,
           const float* ds_fin, float* xs, float* dr, float* dk, float* dv,
           float* dw, float* du_part, int B, int S, int H,
           cudaStream_t stream) {
  const int nchk = (S + CKPT_EVERY - 1) / CKPT_EVERY;
  const float* carried = ds_fin;
  if (nchk > 1) {                      // dS entering each chunk, into xs
    if (xs == nullptr) return (int)cudaErrorInvalidValue;
    using C = Carry<N>;
    cudaError_t e = cudaFuncSetAttribute(
        wkv_bwd_carry_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return (int)e;
    wkv_bwd_carry_kernel<N><<<dim3(C::TILES, H, B), C::THREADS, C::SMEM,
                              stream>>>(r, w, dy, ds_fin, xs, S, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    carried = xs;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = walk_config<N>(cfg, attr, B, S, H, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, wkv_bwd_chunk_kernel<N>, r, k, v, w, u, dy,
                         ckpt, carried, dr, dk, dv, dw, du_part, S, H);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int N>
int clusters(int B, int S, int H) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = walk_config<N>(cfg, attr, B, S, H, nullptr);
  if (e != cudaSuccess) return -(int)e;
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, wkv_bwd_chunk_kernel<N>, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

}  // namespace

// ds_fin may be null (the final state's gradient is zero); xs is scratch of
// ckpt's shape, needed when S > CKPT_EVERY (null otherwise); N in 8, 16,
// 32, 64 (kernels/wkv.py BWD_HEAD_SIZES), others return
// cudaErrorInvalidValue.
extern "C" int wkv_bwd_f32(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* dy,
                           const void* ckpt, const void* ds_fin, void* xs,
                           void* dr, void* dk, void* dv, void* dw,
                           void* du_part, int B, int S, int H, int N,
                           void* stream) {
  const float *rf = (const float*)r, *kf = (const float*)k,
              *vf = (const float*)v, *wf = (const float*)w,
              *uf = (const float*)u, *dyf = (const float*)dy,
              *cf = (const float*)ckpt, *sf = (const float*)ds_fin;
  float *xf = (float*)xs, *drf = (float*)dr, *dkf = (float*)dk,
        *dvf = (float*)dv, *dwf = (float*)dw, *duf = (float*)du_part;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_BWD(NN)                                                    \
  if (N == NN)                                                           \
    return launch<NN>(rf, kf, vf, wf, uf, dyf, cf, sf, xf, drf, dkf, dvf, \
                      dwf, duf, B, S, H, s);
  REPRO_BWD(8) REPRO_BWD(16) REPRO_BWD(32) REPRO_BWD(64)
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}

// Clusters of the walk that the card keeps resident at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int wkv_bwd_clusters(int B, int S, int H, int N) {
#define REPRO_OCC(NN) \
  if (N == NN) return clusters<NN>(B, S, H);
  REPRO_OCC(8) REPRO_OCC(16) REPRO_OCC(32) REPRO_OCC(64)
#undef REPRO_OCC
  return -(int)cudaErrorInvalidValue;
}
