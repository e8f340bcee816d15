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
//   ddt_t   = dh . (a o e_t o h_{t-1}) + x_t (dh . B_t)
//   dA     += dh dt_t e_t o h_{t-1}  dD += dy_t x_t   (summed over b, t)
//   dh     <- e_t o dh
// starting from the final state's gradient (dh_fin, or zero).
// Contract (all f32, contiguous):
//   x, dt, dy  [B, S, D]    b, c  [B, S, N]    a  [D, N]    d  [D]
//   ckpt  [B, D, ceil(S / CKPT_EVERY), N]  the forward's h before steps 0,
//         CKPT_EVERY, ... (csrc/selective_scan.cu, given a ckpt pointer)
//   dh_fin [B, D, N] or null
//   split: 0, or 1 to split the sequence at the checkpoints; then
//   xs    [B, D, ceil(S / CKPT_EVERY), N] scratch: dh entering each chunk
//   dx, ddt  [B, S, D]
//   db_part, dc_part  [blocks, B, S, N]  (dB and dC of each block's
//         channels; the wrapper sums the blocks in a fixed order)
//   da_part [groups, B, D, N], dd_part [groups, B, D]  (groups: the
//         chunks when split, else 1; summed over groups and B by the
//         wrapper)
// No floating-point atomics: every output element has one writer and every
// sum runs in a fixed order, so two runs give the same bits.
//
// What bounds it: x, dt, dy, dx and ddt move once (20 bytes per (b, t, d)),
// against one exp and ~16 f32 operations per (b, t, d, n): at N = 16 the
// special-function unit and the bytes set nearly the same floor (0.053 ms
// at Jamba's layer, B 8, S 128, D 8192; 0.106 at B 1, S 2048).  The first
// design ran at 13.2x and 23.7x that bound: one serial walk over all of S
// per (b, channel block) gave B 1, S 2048 only 128 blocks for 132 SMs,
// every step read x, dt, dy, B and C from global memory inside the loop,
// each step computed its exp three times (replay, replay, walk), and each
// step ran a reduce-scatter of dB and dC.  This one runs at ~6.3x and
// ~7.3x (0.332 and 0.769 ms on an H100 80GB HBM3 at 700 W, PERF.md), held
// by latency with 16 warps an SM (the registers allow no more).  Removing
// parts in turn on that card at B 1, S 2048 (scripts/bwd_ablations.py,
// 0.727 ms whole): the carry takes 0.13 ms; the walk is 0.12 ms shorter
// without the dB and dC reduce-scatters and 0.09 without the staging
// copies.
//
// Design:
// * A sequence split at the forward's checkpoints, where (b, channel block)
//   blocks do not fill the card (kernels/selective_scan.py bwd_plan: B 1,
//   S 2048 splits; B 8, S 128 does not, where the split measured 11%
//   slower).  Only dh crosses chunks, and it follows a diagonal linear
//   recurrence, so a first kernel (selective_scan_bwd_carry_kernel, two
//   states a thread, which beat one and four by 4% and 3%, stages of 32
//   steps) walks dh alone back over the sequence (its fma and ex2.approx
//   are the walk's, so the dh entering each chunk has the bits a single
//   walk reaches, and dx, ddt, dB and dC are the same bits split or not)
//   and writes it to xs; the walk proper then runs every (b, chunk,
//   channel block) at once, and its dA, dD partials go out per chunk,
//   summed by the wrapper in chunk order.
// * NPT = 4 states a thread, L = N / 4 lanes a channel (adjacent lanes);
//   blocks of 256 threads over D.  h_{t-1} is needed while t runs backward:
//   the chunk is replayed forward from its checkpoint, keeping h at the
//   start of each sub-chunk of T = 8 steps in shared memory (each thread its
//   own words); each sub-chunk, last first, is then replayed from there with
//   its T + 1 states and T exps in registers, and walked back.  The replay
//   repeats the forward's arithmetic (ex2.approx of dt * a * log2(e), the
//   same fmas), so the states are the forward's bits, and the walk reads its
//   exps and h_t from the replay: two exps an element and step, not three.
//   A whole sub-chunk and the ragged last one are compiled apart.
// * Each sub-chunk's x, dt, dy (the block's channels) and B, C go through
//   a two-stage cp.async ring in shared memory, one sub-chunk ahead of use
//   (the forward replay stages x, dt and B only).
// * Reductions leave the step loop: the walk keeps its per-step partials in
//   registers, then reduce-scatters them (each round halves the values a
//   lane holds): dB and dC every TH = 2 steps over the warp's channels, then
//   over the block's warps in shared memory, in warp order, into the
//   block's partial; dx and ddt once a sub-chunk over the channel's L lanes.
// Occupancy at N 16: 51,200 bytes of shared memory and at most 128
// registers a thread (launch bounds), so 2 blocks (16 warps) an SM; the
// carry kernel runs 128 threads (16 channels) and 18 KiB a block.
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int CKPT_EVERY = 64;       // csrc/selective_scan.cu
constexpr int T = 8;                 // steps a sub-chunk (states in registers)
constexpr int SUBS = CKPT_EVERY / T;
constexpr int NPT = 4;               // states a thread
constexpr int TH = T / 4;            // steps a dB and dC reduce-scatter
constexpr int VB = 2 * NPT * TH;     // dB and dC partials a thread, TH steps
constexpr int VX = 2 * T;            // dx and ddt sums a thread, sub-chunk
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
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

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

template <int N, int THREADS>
struct Tile {
  static constexpr int L = N / NPT;            // lanes a channel
  static constexpr int CW = 32 / L;            // channels a warp
  static constexpr int CH = THREADS / L;       // channels a block
  static constexpr int LOGR = ilog2(CW);       // rounds over a warp's channels
  static constexpr int LOGL = ilog2(L);        // rounds over a channel's lanes
  // values a lane keeps after each reduce-scatter
  static constexpr int KEEPB = (VB >> LOGR) > 0 ? (VB >> LOGR) : 1;
  static constexpr int KEEPX = (VX >> LOGL) > 2 ? (VX >> LOGL) : 2;
  // one stage: x, dt, dy [3][T][CH], B, C [2][T][N]
  static constexpr int STAGE = T * (3 * CH + 2 * N);
  // the walk's shared memory: the ring, sub-chunk states [SUBS-1][NPT]
  // [THREADS], warp partials [WARPS][T][2][N]
  static constexpr int SMEM =
      4 * (2 * STAGE + (SUBS - 1) * NPT * THREADS + (THREADS / 32) * T * 2 * N);
  static_assert(N % NPT == 0 && L <= 32, "4 states a lane, a channel a warp");
  static_assert(CH % 4 == 0, "a block's row is whole 16-byte pieces");
};

// The carry: CNPT states a thread, CH channels a block (N / CNPT threads
// each), stages of TC steps (its steps are short, so long stages keep its
// loads far enough ahead).
constexpr int TC = 32;
constexpr int CPT = CKPT_EVERY / TC;   // carry stages a chunk
template <int N>
struct CarryTile {
  static constexpr int CNPT = 2;                 // states a thread
  static constexpr int LC = N / CNPT;            // threads a channel
  static constexpr int CH = LC >= 32 ? 4 : 128 / LC;
  static constexpr int THREADS = CH * LC;
  // a three-stage ring of dt, dy [2][TC][CH] and C [TC][N]
  static constexpr int STAGE = TC * (2 * CH + N);
  static constexpr int SMEM = 4 * 3 * STAGE;
};

// The V values of every lane summed over the lanes ``l << k`` apart, k <
// LOGR: each round halves what a lane holds (the upper or lower half by its
// bit k) while more than MIN are left, then adds them across.  ``idx``
// accumulates the index of the lane's first kept value.
template <int H, int K, int LOGR, int MIN>
struct Scatter {
  template <int V>
  __device__ __forceinline__ static void run(float (&v)[V], int lane, int l,
                                             int& idx) {
    if constexpr (K < LOGR) {
      const int off = l << K;
      if constexpr (H > MIN) {
        constexpr int HALF = H / 2;
        const bool hi = (lane & off) != 0;
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
          const float send = hi ? v[i] : v[i + HALF];
          const float keep = hi ? v[i + HALF] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
        if (hi) idx += HALF;
        Scatter<HALF, K + 1, LOGR, MIN>::run(v, lane, l, idx);
      } else {
#pragma unroll
        for (int i = 0; i < H; ++i)
          v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
        Scatter<H, K + 1, LOGR, MIN>::run(v, lane, l, idx);
      }
    }
  }
};

// ST steps of ``cnt`` channel values (from channel ``d0``, row ``row0``)
// into ``dst`` and of B or C rows into ``rdst``, in shared memory; 16-byte
// copies where D % 4 == 0.
template <int ST, int CH, int N, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* const* chan,
                                           int nchan, float* rdst,
                                           const float* const* rows, int nrows,
                                           long long row0, int seq_len, int dim,
                                           int d0, int cnt, int tid) {
  const bool vec = dim % 4 == 0;
  const int per = vec ? CH / 4 : CH;
  for (int e = tid; e < nchan * ST * per; e += THREADS) {
    const int a = e / (ST * per), c = e / per % ST, j = e % per;
    if (c >= seq_len) continue;
    const float* src = chan[a] + (row0 + c) * dim + d0;
    float* out = dst + (a * ST + c) * CH;
    if (vec) {
      if (4 * j < cnt) cp_async16(out + 4 * j, src + 4 * j);
    } else if (j < cnt) {
      cp_async4(out + j, src + j);
    }
  }
  constexpr int RP = N / 4;
  for (int e = tid; e < nrows * ST * RP; e += THREADS) {
    const int a = e / (ST * RP), c = e / RP % ST, j = e % RP;
    if (c < seq_len)
      cp_async16(rdst + (a * ST + c) * N + 4 * j,
                 rows[a] + (row0 + c) * N + 4 * j);
  }
}

// dh walked back over chunks nchk-1 .. 1 alone; xs[b, d, j] = dh entering
// chunk j's walk (the gradient of h after its last step).
template <int N>
__global__ void __launch_bounds__(CarryTile<N>::THREADS)
selective_scan_bwd_carry_kernel(const float* __restrict__ dt,
                                const float* __restrict__ cm,
                                const float* __restrict__ a,
                                const float* __restrict__ dy,
                                const float* __restrict__ dh_fin,
                                float* __restrict__ xs, int seq, int dim) {
  using Tc = CarryTile<N>;
  constexpr int CH = Tc::CH;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [3][dt, dy: TC*CH; C: TC*N]
  constexpr int CNPT = Tc::CNPT;
  const int tid = threadIdx.x, ch = tid / Tc::LC, n0 = tid % Tc::LC * CNPT;
  const int d0 = blockIdx.x * CH, d = d0 + ch;
  const bool live = d < dim;
  const int cnt = min(CH, dim - d0);
  const int b = blockIdx.y;
  const long long row = (long long)b * seq;
  const int nchk = (seq + CKPT_EVERY - 1) / CKPT_EVERY;
  const int nsub = (seq + TC - 1) / TC;
  const int items = nsub - CPT;                  // stages after chunk 0

  float a2[CNPT], dh[CNPT];
#pragma unroll
  for (int i = 0; i < CNPT; ++i) {
    a2[i] = live ? a[(long long)d * N + n0 + i] * kLog2e : 0.f;
    dh[i] = live && dh_fin != nullptr
                ? dh_fin[((long long)b * dim + d) * N + n0 + i] : 0.f;
  }
  const float* chan[2] = {dt, dy};
  const float* rows[1] = {cm};
  auto issue = [&](int q) {          // stage nsub - 1 - q
    if (q < items) {
      const int ts = (nsub - 1 - q) * TC;
      float* st = ring + (q % 3) * Tc::STAGE;
      stage_rows<TC, CH, N, Tc::THREADS>(st, chan, 2, st + 2 * TC * CH, rows,
                                         1, row + ts, min(TC, seq - ts), dim,
                                         d0, cnt, tid);
    }
    cp_async_commit();
  };
  auto store = [&](int j) {
    if (live) {
#pragma unroll
      for (int i = 0; i < CNPT; ++i)
        xs[(((long long)b * dim + d) * nchk + j) * N + n0 + i] = dh[i];
    }
  };

  issue(0);
  issue(1);
  for (int q = 0; q < items; ++q) {
    cp_async_wait<1>();
    __syncthreads();       // stage q landed; q - 1 is fully consumed
    issue(q + 2);
    const int g = nsub - 1 - q, sl = min(TC, seq - g * TC);
    if (q == 0 || g % CPT == CPT - 1) store(g / CPT);
    const float* st = ring + (q % 3) * Tc::STAGE;
    auto walk = [&](auto whole) {      // compiled apart for a whole stage
      constexpr bool FULL = decltype(whole)::value;
#pragma unroll
      for (int c = TC - 1; c >= 0; --c) {
        if (!FULL && c >= sl) continue;          // the same in every thread
        const float dtc = live ? st[c * CH + ch] : 0.f;
        const float dyc = live ? st[(TC + c) * CH + ch] : 0.f;
#pragma unroll
        for (int i = 0; i < CNPT; ++i)
          dh[i] = fmaf(dyc, st[2 * TC * CH + c * N + n0 + i], dh[i]) *
                  ex2(dtc * a2[i]);
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

// The walk of chunks [j0, j1) of batch row b, last first, over the block's
// channels: j0 = blockIdx.y, j1 = j0 + 1 when split (dh from xs), else all.
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
selective_scan_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ dd,
    const float* __restrict__ dy, const float* __restrict__ ckpt,
    const float* __restrict__ dh_fin, const float* __restrict__ xs,
    float* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ db_part, float* __restrict__ dc_part,
    float* __restrict__ da_part, float* __restrict__ dd_part, int batch,
    int seq, int dim, int split) {
  using Tl = Tile<N, kThreads>;
  constexpr int L = Tl::L, CW = Tl::CW, CH = Tl::CH, STAGE = Tl::STAGE;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [2][STAGE]
  float* sub = ring + 2 * STAGE;                  // [SUBS-1][NPT][kThreads]
  float* wpart = sub + (SUBS - 1) * NPT * kThreads;  // [kWarps][T][2][N]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int part = lane % L, col = lane / L;      // lanes of a channel adjoin
  const int ch = warp * CW + col;                 // the block's channel
  const int d0 = blockIdx.x * CH, d = d0 + ch;
  const bool live = d < dim;
  const int cnt = min(CH, dim - d0);
  const int b = blockIdx.z;
  const long long row = (long long)b * seq;       // first step of b
  const int nchk = (seq + CKPT_EVERY - 1) / CKPT_EVERY;
  const int j0 = split ? blockIdx.y : 0, j1 = split ? j0 + 1 : nchk;
  const long long hrow = ((long long)b * dim + d) * nchk;  // ckpt, xs rows

  float an[NPT], a2[NPT], dh[NPT], da[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    an[i] = live ? a[(long long)d * N + part * NPT + i] : 0.f;
    a2[i] = an[i] * kLog2e;
    da[i] = 0.f;
  }
  {
    const float* src =
        split ? (xs == nullptr ? nullptr : xs + (hrow + j0) * N)
              : (dh_fin == nullptr ? nullptr
                                   : dh_fin + ((long long)b * dim + d) * N);
#pragma unroll
    for (int i = 0; i < NPT; ++i)
      dh[i] = live && src != nullptr ? src[part * NPT + i] : 0.f;
  }
  const float dskip = live ? dd[d] : 0.f;
  float dd_acc = 0.f;
  auto load_ckpt = [&](float (&h)[NPT], int j) {
    if (live) {
      const float4 c4 = *reinterpret_cast<const float4*>(
          ckpt + (hrow + j) * N + part * NPT);
      h[0] = c4.x, h[1] = c4.y, h[2] = c4.z, h[3] = c4.w;
    } else {
#pragma unroll
      for (int i = 0; i < NPT; ++i) h[i] = 0.f;
    }
  };

  // items: per chunk j (last first), sub-chunks 0 .. nsub-2 forward, then
  // nsub-1 .. 0 backward
  auto nsub_of = [&](int j) {
    return (min(CKPT_EVERY, seq - j * CKPT_EVERY) + T - 1) / T;
  };
  const float* chan[3] = {x, dt, dy};
  const float* rows[2] = {bm, cm};
  int ij = j1 - 1, ip = 0, slot = 0;   // the next item to stage, its slot
  auto issue = [&]() {
    if (ij >= j0) {
      const int ns = nsub_of(ij);
      const int i = ip < ns - 1 ? ip : 2 * ns - 2 - ip;
      const int ts = ij * CKPT_EVERY + i * T;
      // the replay (ip < ns - 1) reads x, dt and B only
      const int nc = ip < ns - 1 ? 2 : 3;
      float* st = ring + slot * STAGE;
      stage_rows<T, CH, N, kThreads>(st, chan, nc, st + 3 * T * CH, rows,
                                     nc - 1, row + ts, min(T, seq - ts), dim,
                                     d0, cnt, tid);
      slot ^= 1;
      if (++ip == 2 * ns - 1) ip = 0, --ij;
    }
    cp_async_commit();
  };

  issue();
  int cur = 0;                         // the slot of the item consumed next
  for (int j = j1 - 1; j >= j0; --j) {
    const int t0 = j * CKPT_EVERY, nsub = nsub_of(j);
    float h[NPT];
    load_ckpt(h, j);
    for (int p = 0; p < 2 * nsub - 1; ++p, cur ^= 1) {
      cp_async_wait<0>();
      __syncthreads();     // item p landed; the one before is consumed
      issue();
      const float* st = ring + cur * STAGE;
      const float *sx = st + ch, *sdt = sx + T * CH, *sdy = sdt + T * CH;
      const float* sb = st + 3 * T * CH + part * NPT;
      const float* sc = sb + T * N;
      auto bvec = [&](const float* s, int c, float (&v)[NPT]) {
        const float4 q = reinterpret_cast<const float4*>(s + c * N)[0];
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
      };
      if (p < nsub - 1) {          // pass 1: h at the next sub-chunk
#pragma unroll
        for (int c = 0; c < T; ++c) {
          const float xc = live ? sx[c * CH] : 0.f;
          const float dtc = live ? sdt[c * CH] : 0.f;
          float bv[NPT];
          bvec(sb, c, bv);
          const float dtx = dtc * xc;
#pragma unroll
          for (int e = 0; e < NPT; ++e)
            h[e] = fmaf(ex2(dtc * a2[e]), h[e], dtx * bv[e]);
        }
#pragma unroll
        for (int e = 0; e < NPT; ++e)
          sub[(p * NPT + e) * kThreads + tid] = h[e];
        continue;
      }
      const int i = 2 * nsub - 2 - p, ts = t0 + i * T, sl = min(T, seq - ts);
      float px[VX];                  // [c][dx, ddt]
      float h0[NPT];
      if (i == 0) {
        load_ckpt(h0, j);
      } else {
#pragma unroll
        for (int e = 0; e < NPT; ++e)
          h0[e] = sub[((i - 1) * NPT + e) * kThreads + tid];
      }
      // the replay and the walk, compiled apart for a whole sub-chunk (no
      // step tests between the steps) and for the ragged last one
      auto walk = [&](auto whole) {
        constexpr bool FULL = decltype(whole)::value;
        // the replay: h_{t-1} and h_t for t = ts + c, and e_t
        float hist[T + 1][NPT], ex[T][NPT];
#pragma unroll
        for (int e = 0; e < NPT; ++e) hist[0][e] = h0[e];
#pragma unroll
        for (int c = 0; c < T; ++c) {
          if (FULL || c < sl) {
            const float xc = live ? sx[c * CH] : 0.f;
            const float dtc = live ? sdt[c * CH] : 0.f;
            float bv[NPT];
            bvec(sb, c, bv);
            const float dtx = dtc * xc;
#pragma unroll
            for (int e = 0; e < NPT; ++e) {
              ex[c][e] = ex2(dtc * a2[e]);
              hist[c + 1][e] = fmaf(ex[c][e], hist[c][e], dtx * bv[e]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < NPT; ++e) ex[c][e] = 0.f, hist[c + 1][e] = 0.f;
          }
        }
#pragma unroll
        for (int hf = T / TH - 1; hf >= 0; --hf) {   // the later steps first
          float pb[VB];                  // [c][dB 0..3, dC 0..3]
#pragma unroll
          for (int cc = TH - 1; cc >= 0; --cc) {
            const int c = hf * TH + cc;
            if (!FULL && c >= sl) {      // the same in every thread
#pragma unroll
              for (int q = 0; q < 2 * NPT; ++q) pb[cc * 2 * NPT + q] = 0.f;
              px[2 * c] = px[2 * c + 1] = 0.f;
              continue;
            }
            const float xc = live ? sx[c * CH] : 0.f;
            const float dtc = live ? sdt[c * CH] : 0.f;
            const float dyc = live ? sdy[c * CH] : 0.f;
            float bv[NPT], cv[NPT];
            bvec(sb, c, bv);
            bvec(sc, c, cv);
            const float dtx = dtc * xc;
            float sxp = 0.f, sdtp = 0.f;
#pragma unroll
            for (int e = 0; e < NPT; ++e) {
              dh[e] = fmaf(dyc, cv[e], dh[e]);
              pb[cc * 2 * NPT + e] = dh[e] * dtx;              // dB
              pb[cc * 2 * NPT + NPT + e] = dyc * hist[c + 1][e];  // dC
              sxp = fmaf(dh[e], bv[e], sxp);
              const float q = dh[e] * (ex[c][e] * hist[c][e]);
              da[e] = fmaf(q, dtc, da[e]);
              sdtp = fmaf(q, an[e], sdtp);
              dh[e] *= ex[c][e];
            }
            px[2 * c] = sxp;
            px[2 * c + 1] = sdtp;
            dd_acc = fmaf(dyc, xc, dd_acc);
          }
          // dB and dC of TH steps: over the warp's channels, into the warp's
          // partial
          int ib = 0;
          Scatter<VB, 0, Tl::LOGR, 1>::run(pb, lane, L, ib);
#pragma unroll
          for (int q = 0; q < Tl::KEEPB; ++q) {  // duplicates write alike
            const int f = ib + q, c = hf * TH + f / (2 * NPT);
            const int v = f % (2 * NPT);
            wpart[(warp * T + c) * 2 * N + (v < NPT ? 0 : N) + part * NPT +
                  v % NPT] = pb[q];
          }
        }
      };
      if (sl == T) {
        walk(std::true_type{});
      } else {
        walk(std::false_type{});
      }
      // dx and ddt: the sums over the channel's L lanes
      int ix = 0;
      Scatter<VX, 0, Tl::LOGL, 2>::run(px, lane, 1, ix);
      if (live) {
#pragma unroll
        for (int q = 0; q < Tl::KEEPX; q += 2) {
          const int c = (ix + q) / 2;
          if (c < sl) {            // duplicates (L 16) write alike
            const long long o = (row + ts + c) * dim + d;
            dx[o] = fmaf(dskip, sdy[c * CH], sdt[c * CH] * px[q]);
            ddt[o] = fmaf(sx[c * CH], px[q], px[q + 1]);
          }
        }
      }
      // dB and dC: the block's warps in order
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
    }
  }
  if (live) {
    const long long g = split ? j0 : 0;
    float* out = da_part + ((g * batch + b) * dim + d) * N + part * NPT;
    *reinterpret_cast<float4*>(out) = make_float4(da[0], da[1], da[2], da[3]);
    if (part == 0) dd_part[(g * batch + b) * dim + d] = dd_acc;
  }
}

template <int N>
int launch(const float* x, const float* dt, const float* b, const float* c,
           const float* a, const float* d, const float* dy, const float* ckpt,
           const float* dh_fin, float* xs, float* dx, float* ddt,
           float* db_part, float* dc_part, float* da_part, float* dd_part,
           int B, int S, int D, int split, cudaStream_t stream) {
  using Tl = Tile<N, kThreads>;
  using Tc = CarryTile<N>;
  const int nchk = (S + CKPT_EVERY - 1) / CKPT_EVERY;
  if (split && nchk > 1) {             // dh entering each chunk, into xs
    if (xs == nullptr) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        selective_scan_bwd_carry_kernel<N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Tc::SMEM);
    if (e != cudaSuccess) return (int)e;
    selective_scan_bwd_carry_kernel<N>
        <<<dim3((D + Tc::CH - 1) / Tc::CH, B), Tc::THREADS, Tc::SMEM,
           stream>>>(dt, c, a, dy, dh_fin, xs, S, D);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else if (split) {                  // one chunk: dh_fin enters it
    xs = const_cast<float*>(dh_fin);
  }
  cudaError_t e = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((D + Tl::CH - 1) / Tl::CH, split ? nchk : 1, B);
  selective_scan_bwd_kernel<N><<<grid, kThreads, Tl::SMEM, stream>>>(
      x, dt, b, c, a, d, dy, ckpt, dh_fin, xs, dx, ddt, db_part, dc_part,
      da_part, dd_part, B, S, D, split);
  return (int)cudaGetLastError();
}

}  // namespace

// dh_fin may be null (the final state's gradient is zero); split: 0 or 1
// (kernels/selective_scan.py bwd_plan), xs scratch of ckpt's shape when
// split and S > CKPT_EVERY; N in 4, 8, 16, 32, 64 (kernels/selective_scan.py
// STATE_SIZES), others return cudaErrorInvalidValue.  db_part and dc_part
// have ceil(D / (256 / (N / 4))) blocks (kernels/selective_scan.py
// bwd_blocks).
extern "C" int selective_scan_bwd_f32(
    const void* x, const void* dt, const void* b, const void* c,
    const void* a, const void* d, const void* dy, const void* ckpt,
    const void* dh_fin, void* xs, void* dx, void* ddt, void* db_part,
    void* dc_part, void* da_part, void* dd_part, int B, int S, int D, int N,
    int split, void* stream) {
  const float *xf = (const float*)x, *dtf = (const float*)dt,
              *bf = (const float*)b, *cf = (const float*)c,
              *af = (const float*)a, *df = (const float*)d,
              *dyf = (const float*)dy, *kf = (const float*)ckpt,
              *hf = (const float*)dh_fin;
  float *xsf = (float*)xs, *dxf = (float*)dx, *ddtf = (float*)ddt,
        *dbf = (float*)db_part, *dcf = (float*)dc_part,
        *daf = (float*)da_part, *ddf = (float*)dd_part;
  cudaStream_t s = (cudaStream_t)stream;
  if (split != 0 && split != 1) return (int)cudaErrorInvalidValue;
#define REPRO_BWD(NN)                                                     \
  if (N == NN)                                                            \
    return launch<NN>(xf, dtf, bf, cf, af, df, dyf, kf, hf, xsf, dxf,     \
                      ddtf, dbf, dcf, daf, ddf, B, S, D, split, s);
  REPRO_BWD(4) REPRO_BWD(8) REPRO_BWD(16) REPRO_BWD(32) REPRO_BWD(64)
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}
