// Causal flash attention backward for Hopper (sm_90a), grouped-query layout.
//
// The gradient of the causal softmax attention that flash_attention.cu
// computes.  The TPU side has no backward kernel: the reference trains
// through XLA's autodiff of full_attention / chunked_attention
// (src/repro/models/attention.py), while on the card the port's prefill
// attention is the flash kernel, so its gradient is a kernel too.
// Contract (the forward's layout, query rows packed as r = s*gp + g):
//   q, do, out   [B, S, KVp, gp, hd]     k, v [B, S, KVp, hd]
//   lse          [B, KVp, S*gp] f32: the forward's natural log-sum-exp
//   D (scratch)  [B, KVp, S*gp] f32
//   dq [B, S, KVp, gp, hd], dk, dv [B, S, KVp, hd]
// With P = exp(q.k / sqrt(hd) - lse) on and below the diagonal (0 above):
//   D = rowsum(do * out),  dV = P^T do,  dS = P * (do v^T - D),
//   dQ = dS k / sqrt(hd),  dK = dS^T q / sqrt(hd).
// Three launches (four for wgmma at hd 128), no floating-point atomics and no
// waits between blocks (every output element is summed by one thread in a
// fixed order), so two runs on the same inputs are bit-equal, which the
// fault-tolerant replay of a training run relies on.
//
// Routes, chosen by the wrapper from dtype and head dim, never on a failure
// (flash_attention.bwd_route):
//
// bf16 at hd 64 and 128 (every full-size config; entry
// flash_attention_bwd_bf16_wgmma), on wgmma with f32 accumulators.  What
// bounds it: the tensor-core operations (seven S^2/2 x hd tile products:
// the dK/dV pass forms S^T, dP^T, P^T dO, dS^T Q and the dQ pass S, dP,
// dS K, against the five of a fused pass), then the L2 -> shared-memory
// traffic of re-reading the other side's tiles, then the exponentials
// (each pass forms P).  Design (FA3's shape, kept free of atomics):
//   * row_dot: D, as below;
//   * dkdv_wg_kernel: a block of three warpgroups per 128 keys of one
//     (batch, kv head).  Warpgroup 0 is the producer: setmaxnreg moves its
//     registers to the consumers (24 and 240 a thread) and one warp works.
//     Its lane 0 loads the block's K and V
//     once and each query tile's Q and dO by TMA (128-byte swizzle, 5-D maps
//     over (hd, gp, KVp, S, B) whose box is npos = 64/gp whole positions)
//     into a ring of stages guarded by mbarriers; its 32 lanes copy the
//     tile's lse and D rows with cp.async, arriving on the same barrier.
//     Warpgroups 1 and 2 own 64 keys each and walk the query tiles on or
//     below the diagonal: S^T = K Q^T and dP^T = V dO^T as wgmma from shared
//     memory, P^T and dS^T on the accumulators, dV += P^T dO and dK += dS^T Q
//     as wgmma with A from registers (the accumulators as bf16 fragments)
//     and Q, dO as MN-major B.  The gp query heads of a kv head are rows of
//     the same tiles, so dK and dV are summed in the block.  Named barriers
//     pass a turn between the two warpgroups (ping-pong), so one's
//     exponentials run while the other's products do.  At hd 128 the dK and
//     dV accumulators (128 registers a thread) leave too few for S^T and
//     dP^T, so the kernel runs twice, dV then dK, each forming S^T again;
//   * dq_wg_kernel: the same block shape per 2*npos positions (two tiles of
//     npos*gp <= 64 packed rows, one a warpgroup); the producer loads both Q
//     and dO tiles once and streams the K and V tiles at or below the last
//     row; each warpgroup forms S and dP, dS in registers, and dQ += dS K
//     with K an MN-major B operand.
//   Blocks of one (batch, kv head) are adjacent in the grid, longest first,
//   so the tiles they share are read from L2.  Only tiles that cross the
//   diagonal are masked: a row past a tile's packed rows (npos*gp < 64) or
//   past the sequence has zero Q and dO rows (TMA's out-of-range fill, or
//   zeroed once at the start) and zero lse and D, so it adds exactly 0.
//
// bf16 at any other hd up to 256 (entry flash_attention_bwd_bf16), on the
// bf16 tensor cores with mma.sync m16n8k16 and f32 accumulators.  What
// bounds it: the same operations, and the shared-memory reads that feed
// them.  Design (FA2's):
//   * row_dot: one warp a packed row, D in f32 from the bf16 do and out;
//   * dkdv: a block of 4 warps owns 64 keys of one (batch, kv head), 16 a
//     warp, keeps its K and V tile in shared memory and walks the query
//     tiles on or below the diagonal (rows r >= k0*gp), so the gp heads of
//     the kv head are summed inside the block; Q and dO tiles are
//     double-buffered with cp.async.  Per tile a warp forms S^T = K Q^T and
//     dP^T = V dO^T, rebuilds P^T from lse, and adds P^T dO to dV and
//     dS^T Q to dK, P^T and dS^T going from the accumulators to bf16 A
//     fragments in registers (as the forward's P).  At hd 256 the dK and dV
//     accumulators (2 x 128 f32 a thread) would spill, so that width runs
//     the kernel twice, once for each;
//   * dq: a block of 4 warps owns 64 packed query rows and walks the key
//     tiles at or below its last row, as the forward does, adding dS K.
//   Tiles are padded to a power-of-two head dim and XOR-swizzled as in the
//   forward, so each ldmatrix (plain and .trans) is free of bank conflicts.
//   P and dS enter their products as bf16 (8 bits), as in FA2.
//
// f32 (the f32 plans), on CUDA cores, simple: blocks of 256 threads, 16
// keys (dK, dV) or 16 query rows (dQ) a block, S, dP, P and dS for a tile
// in shared memory, each output element summed by one thread.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte slot of chunk c of row r in a [rows][HDP] bf16 tile (the
// forward's swizzle)
template <int HDP>
__device__ __forceinline__ int slot(int r, int c) {
  constexpr int CH = HDP / 8;
  if (CH >= 8) return r * CH + (c ^ (r & 7));
  if (CH == 4) return r * CH + (c ^ ((r >> 1) & 3));
  return r * CH + (c ^ ((r >> 2) & 1));          // CH == 2
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<unsigned*>(&v);
}

// 16 bytes of one row (8 bf16 from dim 8c), zero past hd or where !ok
// (the forward's stage16)
__device__ __forceinline__ void stage16(uint4* dst, const __nv_bfloat16* row,
                                        int c, int hd, bool ok, bool vec,
                                        const __nv_bfloat16* any) {
  ok = ok && 8 * c < hd;
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(ok ? row + 8 * c : any),
                    "r"(ok ? 16 : 0));
    return;
  }
  __align__(16) __nv_bfloat16 e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = ok && 8 * c + i < hd ? row[8 * c + i] : __float2bfloat16(0.f);
  *dst = *reinterpret_cast<uint4*>(e);
}

// (x, y) to dims dim, dim + 1 of a bf16 row (dims past hd dropped)
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y,
                                       int dim, int hd, bool vec) {
  if (vec) {
    if (dim < hd) *reinterpret_cast<unsigned*>(p) = pack(x, y);
    return;
  }
  if (dim < hd) p[0] = __float2bfloat16(x);
  if (dim + 1 < hd) p[1] = __float2bfloat16(y);
}

// ============================================================ D = do . out
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(256)
row_dot_kernel(const T* __restrict__ dout, const T* __restrict__ out,
               float* __restrict__ D, int seq, int kvp, int gp, int hd,
               long long total) {
  const long long R = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (R >= total) return;                      // warp-uniform
  const int rows = seq * gp;
  const long long bh = R / rows;
  const int r = (int)(R - bh * rows);
  const long long b = bh / kvp;
  const int h = (int)(bh - b * kvp);
  const int s = r / gp, g = r - s * gp;
  const long long off = (((b * seq + s) * kvp + h) * gp + g) * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f(dout[off + d]), to_f(out[off + d]), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  if (lane == 0) D[R] = acc;
}

template <typename T>
int launch_row_dot(const void* dout, const void* out, float* D, int B, int S,
                   int kvp, int gp, int hd, cudaStream_t stream) {
  const long long total = (long long)B * kvp * S * gp;
  row_dot_kernel<T><<<(unsigned)((total + 7) / 8), 256, 0, stream>>>(
      (const T*)dout, (const T*)out, D, S, kvp, gp, hd, total);
  return (int)cudaGetLastError();
}

// ============================================================ bf16 dK, dV
constexpr int KV_THREADS = 128;      // 4 warps, 16 keys each
constexpr int KV_BK = 64;            // keys per block
// query rows per tile: 64 up to hd 64, 32 beyond (S^T and dP^T registers)
__host__ __device__ constexpr int kv_bq(int hdp) { return hdp <= 64 ? 64 : 32; }

template <int HDP>
constexpr size_t dkdv_smem() {
  return (size_t)(2 * KV_BK + 4 * kv_bq(HDP)) * HDP * 2 +
         (size_t)4 * kv_bq(HDP) * sizeof(float);
}

template <int HDP, bool DK, bool DV>
__global__ void __launch_bounds__(KV_THREADS, 1)
dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ D,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int seq, int kvp, int gp, int hd, float scale_log2,
               float scale, int vec) {
  constexpr int CH = HDP / 8;        // 16-byte chunks per row = n8 tiles
  constexpr int KS = HDP / 16;       // k16 steps over the head dim
  constexpr int BQ = kv_bq(HDP);
  constexpr int QT = BQ / 8;         // n8 tiles of query rows
  extern __shared__ uint4 smem[];
  uint4* ks = smem;                          // [KV_BK][CH]
  uint4* vs = ks + KV_BK * CH;               // [KV_BK][CH]
  uint4* qs = vs + KV_BK * CH;               // [2][BQ][CH]
  uint4* os = qs + 2 * BQ * CH;              // [2][BQ][CH]  dO
  float* ls = reinterpret_cast<float*>(os + 2 * BQ * CH);  // [2][BQ] lse*log2e
  float* dsm = ls + 2 * BQ;                  // [2][BQ]  D

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int rows = seq * gp;
  const int k0 = blockIdx.x * KV_BK;
  const long long q_pos = (long long)kvp * gp * hd;
  const long long q_base = ((long long)b * seq * kvp + h) * gp * hd;
  const long long kv_pos = (long long)kvp * hd;
  const long long kv_base = ((long long)b * seq * kvp + h) * hd;
  const long long st_base = ((long long)b * kvp + h) * rows;
  const bool vc = vec != 0;

  for (int i = tid; i < KV_BK * CH; i += KV_THREADS) {
    const int j = i / CH, c = i % CH, p = k0 + j;
    const long long off = kv_base + (long long)p * kv_pos;
    stage16(&ks[slot<HDP>(j, c)], k + off, c, hd, p < seq, vc, k);
    stage16(&vs[slot<HDP>(j, c)], v + off, c, hd, p < seq, vc, v);
  }
  auto stage_q = [&](int t, int buf) {
    const int r0 = t * BQ;
    uint4* qb = qs + buf * BQ * CH;
    uint4* ob = os + buf * BQ * CH;
    for (int i = tid; i < BQ * CH; i += KV_THREADS) {
      const int rl = i / CH, c = i % CH, r = r0 + rl;
      const int s = r / gp, g = r - s * gp;
      const long long off = q_base + s * q_pos + (long long)g * hd;
      stage16(&qb[slot<HDP>(rl, c)], q + off, c, hd, r < rows, vc, q);
      stage16(&ob[slot<HDP>(rl, c)], dout + off, c, hd, r < rows, vc, dout);
    }
    for (int i = tid; i < BQ; i += KV_THREADS) {
      const int r = r0 + i;
      ls[buf * BQ + i] = r < rows ? lse[st_base + r] * LOG2E : 0.f;
      dsm[buf * BQ + i] = r < rows ? D[st_base + r] : 0.f;
    }
  };
  const int t_first = k0 * gp / BQ;          // first tile with a row at k0
  const int t_end = (rows + BQ - 1) / BQ;
  stage_q(t_first, 0);
  asm volatile("cp.async.commit_group;\n");

  const int kw0 = k0 + warp * 16;            // the warp's first key
  const int key_a = kw0 + gid, key_b = key_a + 8;
  const int arow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  float dk_acc[DK ? CH : 1][4], dv_acc[DV ? CH : 1][4];
#pragma unroll
  for (int d = 0; d < CH; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (DK) dk_acc[DK ? d : 0][e] = 0.f;
      if (DV) dv_acc[DV ? d : 0][e] = 0.f;
    }

  for (int t = t_first; t < t_end; ++t) {
    const int buf = (t - t_first) & 1;
    asm volatile("cp.async.wait_group 0;\n");
    __syncthreads();      // tile t landed; every warp is done with t - 1
    if (t + 1 < t_end) stage_q(t + 1, buf ^ 1);
    asm volatile("cp.async.commit_group;\n");
    const int r0 = t * BQ;
    const int last_pos = (min(r0 + BQ, rows) - 1) / gp;
    if (kw0 >= seq || last_pos < kw0) continue;  // no row sees the warp's keys
    const uint4* qb = qs + buf * BQ * CH;
    const uint4* ob = os + buf * BQ * CH;
    const float* lb = ls + buf * BQ;
    const float* db = dsm + buf * BQ;

    // S^T = K_w Q^T and dP^T = V_w dO^T: 16 keys x BQ rows; n8 tile j
    // holds rows r0 + 8j .. + 7
    float st[QT][4], dpt[DK ? QT : 1][4];
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[j][e] = 0.f;
        if (DK) dpt[DK ? j : 0][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned ka[4], va[4];
      ldsm_x4(ka, &ks[slot<HDP>(arow, 2 * kk + (lane >> 4))]);
      if (DK) ldsm_x4(va, &vs[slot<HDP>(arow, 2 * kk + (lane >> 4))]);
#pragma unroll
      for (int p = 0; p < QT / 2; ++p) {
        const int qr = 16 * p + (lane & 7) + ((lane >> 4) << 3);
        unsigned bq[4];
        ldsm_x4(bq, &qb[slot<HDP>(qr, 2 * kk + ((lane >> 3) & 1))]);
        mma_bf16(st[2 * p], ka, bq[0], bq[1]);
        mma_bf16(st[2 * p + 1], ka, bq[2], bq[3]);
        if (DK) {
          unsigned bo[4];
          ldsm_x4(bo, &ob[slot<HDP>(qr, 2 * kk + ((lane >> 3) & 1))]);
          mma_bf16(dpt[DK ? 2 * p : 0], va, bo[0], bo[1]);
          mma_bf16(dpt[DK ? 2 * p + 1 : 0], va, bo[2], bo[3]);
        }
      }
    }
    // P^T and dS^T in place: element (key_a | key_b, row r0 + 8j + 2tig + e)
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rl = 8 * j + 2 * tig + e, r = r0 + rl;
        const int pos = r < rows ? r / gp : -1;
        const float l2 = lb[rl];
        const float pa = key_a <= pos ? ex2(fmaf(st[j][e], scale_log2, -l2))
                                      : 0.f;
        const float pb = key_b <= pos
                             ? ex2(fmaf(st[j][2 + e], scale_log2, -l2)) : 0.f;
        st[j][e] = pa;
        st[j][2 + e] = pb;
        if (DK) {
          const float dd = db[rl];
          dpt[DK ? j : 0][e] = pa * (dpt[DK ? j : 0][e] - dd);
          dpt[DK ? j : 0][2 + e] = pb * (dpt[DK ? j : 0][2 + e] - dd);
        }
      }
    // dV += P^T dO and dK += dS^T Q, 16 query rows at a time
#pragma unroll
    for (int c = 0; c < QT / 2; ++c) {
      unsigned pa[4], sa[4];
      pa[0] = pack(st[2 * c][0], st[2 * c][1]);
      pa[1] = pack(st[2 * c][2], st[2 * c][3]);
      pa[2] = pack(st[2 * c + 1][0], st[2 * c + 1][1]);
      pa[3] = pack(st[2 * c + 1][2], st[2 * c + 1][3]);
      if (DK) {
        sa[0] = pack(dpt[DK ? 2 * c : 0][0], dpt[DK ? 2 * c : 0][1]);
        sa[1] = pack(dpt[DK ? 2 * c : 0][2], dpt[DK ? 2 * c : 0][3]);
        sa[2] = pack(dpt[DK ? 2 * c + 1 : 0][0], dpt[DK ? 2 * c + 1 : 0][1]);
        sa[3] = pack(dpt[DK ? 2 * c + 1 : 0][2], dpt[DK ? 2 * c + 1 : 0][3]);
      }
      const int rr = 16 * c + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int d = 0; d < CH; d += 2) {
        if (DV) {
          unsigned bo[4];
          ldsm_x4_t(bo, &ob[slot<HDP>(rr, d + (lane >> 4))]);
          mma_bf16(dv_acc[DV ? d : 0], pa, bo[0], bo[1]);
          mma_bf16(dv_acc[DV ? d + 1 : 0], pa, bo[2], bo[3]);
        }
        if (DK) {
          unsigned bq[4];
          ldsm_x4_t(bq, &qb[slot<HDP>(rr, d + (lane >> 4))]);
          mma_bf16(dk_acc[DK ? d : 0], sa, bq[0], bq[1]);
          mma_bf16(dk_acc[DK ? d + 1 : 0], sa, bq[2], bq[3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

#pragma unroll
  for (int d = 0; d < CH; ++d) {
    const int dim = 8 * d + 2 * tig;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = kw0 + gid + 8 * half;
      if (key >= seq) continue;
      const long long off = kv_base + (long long)key * kv_pos + dim;
      if (DK)
        store2(dk + off, dk_acc[DK ? d : 0][2 * half] * scale,
               dk_acc[DK ? d : 0][2 * half + 1] * scale, dim, hd, vc);
      if (DV)
        store2(dv + off, dv_acc[DV ? d : 0][2 * half],
               dv_acc[DV ? d : 0][2 * half + 1], dim, hd, vc);
    }
  }
}

// ============================================================ bf16 dQ
constexpr int DQ_THREADS = 128;      // 4 warps, 16 query rows each
constexpr int DQ_ROWS = 64;          // packed query rows per block
// keys per tile: 64 up to hd 128, 32 at hd 256 (S and dP registers)
__host__ __device__ constexpr int dq_bk(int hdp) { return hdp <= 128 ? 64 : 32; }

template <int HDP>
constexpr size_t dq_smem() {
  return (size_t)(2 * DQ_ROWS + 4 * dq_bk(HDP)) * HDP * 2 +
         (size_t)2 * DQ_ROWS * sizeof(float);
}

template <int HDP>
__global__ void __launch_bounds__(DQ_THREADS, 1)
dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ D,
             __nv_bfloat16* __restrict__ dq, int seq, int kvp, int gp, int hd,
             float scale_log2, float scale, int vec) {
  constexpr int CH = HDP / 8;
  constexpr int KS = HDP / 16;
  constexpr int BK = dq_bk(HDP);
  constexpr int KT = BK / 8;         // n8 tiles of keys
  extern __shared__ uint4 smem[];
  uint4* qs = smem;                          // [DQ_ROWS][CH]
  uint4* os = qs + DQ_ROWS * CH;             // [DQ_ROWS][CH]  dO
  uint4* ks = os + DQ_ROWS * CH;             // [2][BK][CH]
  uint4* vs = ks + 2 * BK * CH;              // [2][BK][CH]
  float* ls = reinterpret_cast<float*>(vs + 2 * BK * CH);  // [DQ_ROWS]
  float* dsm = ls + DQ_ROWS;                 // [DQ_ROWS]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int rows = seq * gp;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * DQ_ROWS;  // long rows first
  const long long q_pos = (long long)kvp * gp * hd;
  const long long q_base = ((long long)b * seq * kvp + h) * gp * hd;
  const long long kv_pos = (long long)kvp * hd;
  const long long kv_base = ((long long)b * seq * kvp + h) * hd;
  const long long st_base = ((long long)b * kvp + h) * rows;
  const bool vc = vec != 0;

  for (int i = tid; i < DQ_ROWS * CH; i += DQ_THREADS) {
    const int rl = i / CH, c = i % CH, r = r0 + rl;
    const int s = r / gp, g = r - s * gp;
    const long long off = q_base + s * q_pos + (long long)g * hd;
    stage16(&qs[slot<HDP>(rl, c)], q + off, c, hd, r < rows, vc, q);
    stage16(&os[slot<HDP>(rl, c)], dout + off, c, hd, r < rows, vc, dout);
  }
  for (int i = tid; i < DQ_ROWS; i += DQ_THREADS) {
    const int r = r0 + i;
    ls[i] = r < rows ? lse[st_base + r] * LOG2E : 0.f;
    dsm[i] = r < rows ? D[st_base + r] : 0.f;
  }
  auto stage_kv = [&](int t, int buf) {
    uint4* kb = ks + buf * BK * CH;
    uint4* vb = vs + buf * BK * CH;
    for (int i = tid; i < BK * CH; i += DQ_THREADS) {
      const int j = i / CH, c = i % CH, p = t * BK + j;
      const long long off = kv_base + (long long)p * kv_pos;
      stage16(&kb[slot<HDP>(j, c)], k + off, c, hd, p < seq, vc, k);
      stage16(&vb[slot<HDP>(j, c)], v + off, c, hd, p < seq, vc, v);
    }
  };
  const int last = min(r0 + DQ_ROWS, rows) - 1;   // the block's last row
  const int ntiles = last / gp / BK + 1;
  stage_kv(0, 0);
  asm volatile("cp.async.commit_group;\n");

  const int wr0 = r0 + warp * 16;
  const int wpos_hi = wr0 < rows ? min(wr0 + 15, rows - 1) / gp : -1;
  const int ra = wr0 + gid, rb = ra + 8;
  const int pos_a = ra < rows ? ra / gp : -1;
  const int pos_b = rb < rows ? rb / gp : -1;
  const int arow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  float dq_acc[CH][4];
#pragma unroll
  for (int d = 0; d < CH; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[d][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    asm volatile("cp.async.wait_group 0;\n");
    __syncthreads();
    if (t + 1 < ntiles) stage_kv(t + 1, buf ^ 1);
    asm volatile("cp.async.commit_group;\n");
    const int k0 = t * BK;
    if (k0 > wpos_hi) continue;
    const uint4* kb = ks + buf * BK * CH;
    const uint4* vb = vs + buf * BK * CH;
    const float l2a = ls[warp * 16 + gid], l2b = ls[warp * 16 + gid + 8];
    const float da = dsm[warp * 16 + gid], db = dsm[warp * 16 + gid + 8];

    float s[KT][4], dp[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned qa[4], oa[4];
      ldsm_x4(qa, &qs[slot<HDP>(arow, 2 * kk + (lane >> 4))]);
      ldsm_x4(oa, &os[slot<HDP>(arow, 2 * kk + (lane >> 4))]);
#pragma unroll
      for (int p = 0; p < KT / 2; ++p) {
        if (k0 + 16 * p > wpos_hi) continue;     // keys no row here sees
        const int key = 16 * p + (lane & 7) + ((lane >> 4) << 3);
        unsigned bk[4], bv[4];
        ldsm_x4(bk, &kb[slot<HDP>(key, 2 * kk + ((lane >> 3) & 1))]);
        mma_bf16(s[2 * p], qa, bk[0], bk[1]);
        mma_bf16(s[2 * p + 1], qa, bk[2], bk[3]);
        ldsm_x4(bv, &vb[slot<HDP>(key, 2 * kk + ((lane >> 3) & 1))]);
        mma_bf16(dp[2 * p], oa, bv[0], bv[1]);
        mma_bf16(dp[2 * p + 1], oa, bv[2], bv[3]);
      }
    }
    // dS = P * (dP - D), P from lse: rows ra (a) and rb (b)
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * tig + e;
        const float pa = key <= pos_a ? ex2(fmaf(s[j][e], scale_log2, -l2a))
                                      : 0.f;
        const float pb = key <= pos_b
                             ? ex2(fmaf(s[j][2 + e], scale_log2, -l2b)) : 0.f;
        dp[j][e] = pa * (dp[j][e] - da);
        dp[j][2 + e] = pb * (dp[j][2 + e] - db);
      }
    // dQ += dS K, 16 keys at a time
#pragma unroll
    for (int c = 0; c < KT / 2; ++c) {
      if (k0 + 16 * c > wpos_hi) continue;
      unsigned sa[4];
      sa[0] = pack(dp[2 * c][0], dp[2 * c][1]);
      sa[1] = pack(dp[2 * c][2], dp[2 * c][3]);
      sa[2] = pack(dp[2 * c + 1][0], dp[2 * c + 1][1]);
      sa[3] = pack(dp[2 * c + 1][2], dp[2 * c + 1][3]);
      const int key = 16 * c + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int d = 0; d < CH; d += 2) {
        unsigned bk[4];
        ldsm_x4_t(bk, &kb[slot<HDP>(key, d + (lane >> 4))]);
        mma_bf16(dq_acc[d], sa, bk[0], bk[1]);
        mma_bf16(dq_acc[d + 1], sa, bk[2], bk[3]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= rows) continue;
    const int s_ = r / gp, g = r - s_ * gp;
    __nv_bfloat16* row = dq + q_base + s_ * q_pos + (long long)g * hd;
#pragma unroll
    for (int d = 0; d < CH; ++d) {
      const int dim = 8 * d + 2 * tig;
      store2(row + dim, dq_acc[d][2 * half] * scale,
             dq_acc[d][2 * half + 1] * scale, dim, hd, vc);
    }
  }
}

template <typename KernelT>
int set_smem(KernelT kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HDP, bool DK, bool DV>
int launch_dkdv(const void* dout, const void* q, const void* k, const void* v,
                const float* lse, const float* D, void* dk, void* dv, int B,
                int S, int kvp, int gp, int hd, float scale_log2, float scale,
                int vec, cudaStream_t stream) {
  int e = set_smem(dkdv_tc_kernel<HDP, DK, DV>, dkdv_smem<HDP>());
  if (e) return e;
  dim3 grid((S + KV_BK - 1) / KV_BK, kvp, B);
  dkdv_tc_kernel<HDP, DK, DV><<<grid, KV_THREADS, dkdv_smem<HDP>(), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, D,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, kvp, gp, hd, scale_log2,
      scale, vec);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_bwd_tc(const void* dout, const void* q, const void* k,
                  const void* v, const void* out, const float* lse, float* D,
                  void* dq, void* dk, void* dv, int B, int S, int kvp, int gp,
                  int hd, cudaStream_t stream) {
  const int vec = hd % 8 == 0 &&
                  (((size_t)dout | (size_t)q | (size_t)k | (size_t)v |
                    (size_t)dq | (size_t)dk | (size_t)dv) % 16) == 0;
  const float scale = 1.f / sqrtf((float)hd);
  const float scale_log2 = LOG2E * scale;
  int e = launch_row_dot<__nv_bfloat16>(dout, out, D, B, S, kvp, gp, hd,
                                        stream);
  if (e) return e;
  if constexpr (HDP <= 128) {
    e = launch_dkdv<HDP, true, true>(dout, q, k, v, lse, D, dk, dv, B, S, kvp,
                                     gp, hd, scale_log2, scale, vec, stream);
  } else {             // dK and dV apart: 2 x 128 accumulators would spill
    e = launch_dkdv<HDP, true, false>(dout, q, k, v, lse, D, dk, dv, B, S,
                                      kvp, gp, hd, scale_log2, scale, vec,
                                      stream);
    if (e) return e;
    e = launch_dkdv<HDP, false, true>(dout, q, k, v, lse, D, dk, dv, B, S,
                                      kvp, gp, hd, scale_log2, scale, vec,
                                      stream);
  }
  if (e) return e;
  e = set_smem(dq_tc_kernel<HDP>, dq_smem<HDP>());
  if (e) return e;
  dim3 grid((S * gp + DQ_ROWS - 1) / DQ_ROWS, kvp, B);
  dq_tc_kernel<HDP><<<grid, DQ_THREADS, dq_smem<HDP>(), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, D,
      (__nv_bfloat16*)dq, S, kvp, gp, hd, scale_log2, scale, vec);
  return (int)cudaGetLastError();
}

// ============================================================ f32
constexpr int F_THREADS = 256;
constexpr int F_KEYS = 16;           // keys per dK/dV block
constexpr int F_ROWS = 32;           // query rows per tile of a dK/dV block
constexpr int F_QROWS = 16;          // query rows per dQ block
constexpr int F_BK = 32;             // keys per tile of a dQ block

size_t f32_smem(int hd) {            // either kernel: 4 tiles + P, dS, lse, D
  return sizeof(float) * ((size_t)(2 * F_KEYS + 2 * F_ROWS) * (hd + 1) +
                          2 * F_KEYS * F_ROWS + 2 * F_ROWS);
}

template <int PER>                   // outputs a thread: 16 * hd / 256
__global__ void __launch_bounds__(F_THREADS)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ D,
                float* __restrict__ dk, float* __restrict__ dv, int seq,
                int kvp, int gp, int hd) {
  extern __shared__ float4 fsm4[];
  const int HS = hd + 1;             // padded rows: no bank conflicts
  float* ks = reinterpret_cast<float*>(fsm4);   // [F_KEYS][HS]
  float* vs = ks + F_KEYS * HS;
  float* qs = vs + F_KEYS * HS;      // [F_ROWS][HS]  q / sqrt(hd)
  float* os = qs + F_ROWS * HS;      // [F_ROWS][HS]  dO
  float* ps = os + F_ROWS * HS;      // [F_KEYS][F_ROWS]  P^T
  float* ss = ps + F_KEYS * F_ROWS;  // [F_KEYS][F_ROWS]  dS^T
  float* ls = ss + F_KEYS * F_ROWS;  // [F_ROWS]
  float* dsm = ls + F_ROWS;          // [F_ROWS]
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int rows = seq * gp;
  const int k0 = blockIdx.x * F_KEYS;
  const long long q_pos = (long long)kvp * gp * hd;
  const long long q_base = ((long long)b * seq * kvp + h) * gp * hd;
  const long long kv_pos = (long long)kvp * hd;
  const long long kv_base = ((long long)b * seq * kvp + h) * hd;
  const long long st_base = ((long long)b * kvp + h) * rows;
  const float rsq = sqrtf((float)hd);

  for (int i = tid; i < F_KEYS * hd; i += F_THREADS) {
    const int j = i / hd, d = i - j * hd, p = k0 + j;
    const long long off = kv_base + (long long)p * kv_pos + d;
    ks[j * HS + d] = p < seq ? k[off] : 0.f;
    vs[j * HS + d] = p < seq ? v[off] : 0.f;
  }
  float dk_acc[PER], dv_acc[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) dk_acc[u] = dv_acc[u] = 0.f;

  for (int t = k0 * gp / F_ROWS; t * F_ROWS < rows; ++t) {
    const int r0 = t * F_ROWS;
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < F_ROWS * hd; i += F_THREADS) {
      const int rl = i / hd, d = i - rl * hd, r = r0 + rl;
      float x = 0.f, o = 0.f;
      if (r < rows) {
        const int s = r / gp, g = r - s * gp;
        const long long off = q_base + s * q_pos + (long long)g * hd + d;
        x = q[off] / rsq;            // as the forward scales q
        o = dout[off];
      }
      qs[rl * HS + d] = x;
      os[rl * HS + d] = o;
    }
    for (int i = tid; i < F_ROWS; i += F_THREADS) {
      const int r = r0 + i;
      ls[i] = r < rows ? lse[st_base + r] : 0.f;
      dsm[i] = r < rows ? D[st_base + r] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < F_KEYS * F_ROWS; e += F_THREADS) {
      const int j = e / F_ROWS, i = e - j * F_ROWS, r = r0 + i;
      float p = 0.f, ds = 0.f;
      if (r < rows && k0 + j <= r / gp) {
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < hd; ++d) {
          s = fmaf(qs[i * HS + d], ks[j * HS + d], s);
          dp = fmaf(os[i * HS + d], vs[j * HS + d], dp);
        }
        p = expf(s - ls[i]);
        ds = p * (dp - dsm[i]);
      }
      ps[e] = p;
      ss[e] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + F_THREADS * u;
      if (e >= F_KEYS * hd) break;
      const int j = e / hd, d = e - j * hd;
      float a = dv_acc[u], c = dk_acc[u];
      for (int i = 0; i < F_ROWS; ++i) {
        a = fmaf(ps[j * F_ROWS + i], os[i * HS + d], a);
        c = fmaf(ss[j * F_ROWS + i], qs[i * HS + d], c);
      }
      dv_acc[u] = a;
      dk_acc[u] = c;               // dS^T (q / sqrt(hd)): dK needs no scale
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + F_THREADS * u;
    if (e >= F_KEYS * hd) break;
    const int j = e / hd, d = e - j * hd, p = k0 + j;
    if (p >= seq) continue;
    const long long off = kv_base + (long long)p * kv_pos + d;
    dk[off] = dk_acc[u];
    dv[off] = dv_acc[u];
  }
}

template <int PER>
__global__ void __launch_bounds__(F_THREADS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ D,
              float* __restrict__ dq, int seq, int kvp, int gp, int hd) {
  extern __shared__ float4 fsm4[];
  const int HS = hd + 1;
  float* qs = reinterpret_cast<float*>(fsm4);   // [F_QROWS][HS]  q / sqrt(hd)
  float* os = qs + F_QROWS * HS;     // [F_QROWS][HS]  dO
  float* ks = os + F_QROWS * HS;     // [F_BK][HS]
  float* vs = ks + F_BK * HS;        // [F_BK][HS]
  float* ss = vs + F_BK * HS;        // [F_QROWS][F_BK]  dS
  float* ls = ss + F_QROWS * F_BK;   // [F_QROWS]
  float* dsm = ls + F_QROWS;         // [F_QROWS]
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int rows = seq * gp;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * F_QROWS;
  const long long q_pos = (long long)kvp * gp * hd;
  const long long q_base = ((long long)b * seq * kvp + h) * gp * hd;
  const long long kv_pos = (long long)kvp * hd;
  const long long kv_base = ((long long)b * seq * kvp + h) * hd;
  const long long st_base = ((long long)b * kvp + h) * rows;
  const float rsq = sqrtf((float)hd);

  for (int i = tid; i < F_QROWS * hd; i += F_THREADS) {
    const int rl = i / hd, d = i - rl * hd, r = r0 + rl;
    float x = 0.f, o = 0.f;
    if (r < rows) {
      const int s = r / gp, g = r - s * gp;
      const long long off = q_base + s * q_pos + (long long)g * hd + d;
      x = q[off] / rsq;
      o = dout[off];
    }
    qs[rl * HS + d] = x;
    os[rl * HS + d] = o;
  }
  for (int i = tid; i < F_QROWS; i += F_THREADS) {
    const int r = r0 + i;
    ls[i] = r < rows ? lse[st_base + r] : 0.f;
    dsm[i] = r < rows ? D[st_base + r] : 0.f;
  }
  float dq_acc[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) dq_acc[u] = 0.f;
  const int last_pos = (min(r0 + F_QROWS, rows) - 1) / gp;
  for (int k0 = 0; k0 <= last_pos; k0 += F_BK) {
    __syncthreads();
    for (int i = tid; i < F_BK * hd; i += F_THREADS) {
      const int j = i / hd, d = i - j * hd, p = k0 + j;
      const long long off = kv_base + (long long)p * kv_pos + d;
      ks[j * HS + d] = p < seq ? k[off] : 0.f;
      vs[j * HS + d] = p < seq ? v[off] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < F_QROWS * F_BK; e += F_THREADS) {
      const int i = e / F_BK, j = e - i * F_BK, r = r0 + i;
      float ds = 0.f;
      if (r < rows && k0 + j <= r / gp) {
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < hd; ++d) {
          s = fmaf(qs[i * HS + d], ks[j * HS + d], s);
          dp = fmaf(os[i * HS + d], vs[j * HS + d], dp);
        }
        ds = expf(s - ls[i]) * (dp - dsm[i]);
      }
      ss[e] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + F_THREADS * u;
      if (e >= F_QROWS * hd) break;
      const int i = e / hd, d = e - i * hd;
      float a = dq_acc[u];
      for (int j = 0; j < F_BK; ++j)
        a = fmaf(ss[i * F_BK + j], ks[j * HS + d], a);
      dq_acc[u] = a;
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + F_THREADS * u;
    if (e >= F_QROWS * hd) break;
    const int i = e / hd, d = e - i * hd, r = r0 + i;
    if (r >= rows) continue;
    const int s = r / gp, g = r - s * gp;
    dq[q_base + s * q_pos + (long long)g * hd + d] = dq_acc[u] / rsq;
  }
}

template <int PER>
int launch_bwd_f32(const void* dout, const void* q, const void* k,
                   const void* v, const void* out, const float* lse, float* D,
                   void* dq, void* dk, void* dv, int B, int S, int kvp, int gp,
                   int hd, cudaStream_t stream) {
  int e = launch_row_dot<float>(dout, out, D, B, S, kvp, gp, hd, stream);
  if (e) return e;
  const size_t smem = f32_smem(hd);
  e = set_smem(dkdv_f32_kernel<PER>, smem);
  if (e) return e;
  dim3 kv_grid((S + F_KEYS - 1) / F_KEYS, kvp, B);
  dkdv_f32_kernel<PER><<<kv_grid, F_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, D, (float*)dk, (float*)dv, S, kvp, gp, hd);
  e = (int)cudaGetLastError();
  if (e) return e;
  e = set_smem(dq_f32_kernel<PER>, smem);
  if (e) return e;
  dim3 q_grid((S * gp + F_QROWS - 1) / F_QROWS, kvp, B);
  dq_f32_kernel<PER><<<q_grid, F_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, D, (float*)dq, S, kvp, gp, hd);
  return (int)cudaGetLastError();
}

// ============================================================ bf16 at hd 64
// and 128: wgmma tiles fed by TMA, warp-specialized
namespace wg {

constexpr int ROWS = 64;         // rows of a wgmma tile (m64)
constexpr int NWG = 2;           // consumer warpgroups a block (a third
                                 // leaves them too few registers)
constexpr int KEYS = 64 * NWG;   // keys a dK/dV block: 64 a consumer warpgroup
constexpr int BK = 64;           // keys a K/V tile of the dQ pass
constexpr int THREADS = 128 * (1 + NWG);   // and one producer warpgroup
// registers a thread after setmaxnreg: the producer's go to the consumers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int PANEL = 64 * 128;  // bytes of a 64-row, 64-column (128 B) panel

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Wait for the phase of `parity` to complete.  A wait of 2**34 cycles
// (about 10 s: a deadlock, never a slow tile) traps, so a fault ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) asm volatile("trap;\n");
}

__device__ __forceinline__ unsigned long long map_addr(const CUtensorMap* m) {
  return reinterpret_cast<unsigned long long>(m);
}

__device__ __forceinline__ void tma_4d(unsigned dst, const CUtensorMap* m,
                                       unsigned bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(map_addr(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_5d(unsigned dst, const CUtensorMap* m,
                                       unsigned bar, int c0, int c1, int c2,
                                       int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(map_addr(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(c4) : "memory");
}

// Shared-memory descriptor of a 128-byte-swizzled operand (the layout TMA's
// SWIZZLE_128B writes: 128-byte rows, 8-row groups 1024 bytes apart).
// K-major (the reduction runs along the row): lbo unused (16).  MN-major
// (the reduction runs down the rows): lbo is the stride between 64-column
// panels.  sbo is the 1024 bytes between 8-row groups in both.
__device__ __forceinline__ unsigned long long desc(unsigned addr,
                                                   unsigned lbo) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)(lbo >> 4) << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

// Named barriers 1 .. NWG pass a turn around the consumer warpgroups: each
// issues its tensor-core products only in its turn, so one warpgroup's
// exponentials run while the others' products do (FA3's ping-pong)
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + (w + 1) % NWG) : "memory");
}
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// tile addresses made opaque once a tile, so the compiler builds each
// descriptor where it is used instead of holding them all in registers
__device__ __forceinline__ void opaque(unsigned& a, unsigned& b, unsigned& c,
                                       unsigned& d) {
  asm volatile("" : "+r"(a), "+r"(b), "+r"(c), "+r"(d));
}

// registers a wgmma writes: kept out of the compiler's reordering
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// m64n64k16 with A and B from shared memory, both K-major; scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32],
                                             unsigned long long da,
                                             unsigned long long db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// m64nNk16 with A from registers (bf16 fragments) and B from shared memory,
// MN-major (tnspB = 1); accumulates into d
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const unsigned (&a)[4],
                                             unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const unsigned (&a)[4],
                                              unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD> struct RsOp;
template <> struct RsOp<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const unsigned (&a)[4],
                                             unsigned long long b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <> struct RsOp<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const unsigned (&a)[4],
                                             unsigned long long b) {
    wgmma_rs_n128(d, a, b);
  }
};

// the A fragments of k-step kk (accumulator columns 16kk .. 16kk + 15) of a
// 64 x 64 f32 accumulator, as bf16 (FA3's conversion: the accumulator's
// layout is the register-A layout, two columns to a register)
__device__ __forceinline__ void frag(unsigned (&a)[4], const float (&d)[32],
                                     int kk) {
  a[0] = pack(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack(d[8 * kk + 6], d[8 * kk + 7]);
}

// rows past npos*gp of every Q and dO tile stay zero: TMA never writes
// them, and a zero row adds nothing to the products
__device__ __forceinline__ void zero_tails(unsigned char* tiles, int panels,
                                           int tile_rows) {
  const int tail = (ROWS - tile_rows) * 8;    // 16-byte chunks a panel
  for (int i = threadIdx.x; i < panels * tail; i += THREADS) {
    const int p = i / tail, c = i - p * tail;
    *reinterpret_cast<uint4*>(tiles + p * PANEL + tile_rows * 128 + c * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// lse and D of one tile's packed rows r0 .. r0 + 63 into shared memory by
// the producer warp, two rows a lane, with cp.async (a row's f32 offset need
// not be 16-byte aligned, as a TMA box's start would have to be); rows past
// the tile or the sequence read 0.
__device__ __forceinline__ void copy_rows(unsigned ls, unsigned ds,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ D,
                                          long long st_base, int r0,
                                          int tile_rows, int rows, int lane) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int rr = lane + 32 * u, r = r0 + rr;
    const bool ok = rr < tile_rows && r < rows;
    const long long off = ok ? st_base + r : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(ls + 4 * rr), "l"(lse + off), "r"(ok ? 4 : 0)
                 : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(ds + 4 * rr), "l"(D + off), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

// the lane's arrival on `bar`, made once its cp.async copies have landed:
// the producer never waits on them
__device__ __forceinline__ void arrive_on_copies(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

template <int HD>
struct KvLayout {                 // dK/dV block, offsets from a 1024-byte base
  static constexpr int NP = HD / 64;              // 64-column panels
  static constexpr int KT = NP * NWG * PANEL;     // K (or V) tile: KEYS keys
  static constexpr int QT = NP * PANEL;           // Q (or dO) tile: 64 rows
  static constexpr int NST = 4;                   // ring stages
  static constexpr int K_OFF = 0, V_OFF = KT;
  static constexpr int Q_OFF = 2 * KT;            // [NST] Q
  static constexpr int O_OFF = Q_OFF + NST * QT;  // [NST] dO
  static constexpr int L_OFF = O_OFF + NST * QT;  // [NST][64] lse
  static constexpr int D_OFF = L_OFF + NST * ROWS * 4;     // [NST][64] D
  static constexpr int BAR_OFF = D_OFF + NST * ROWS * 4;   // kv, full, empty
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * NST) + 1024;
  static_assert(BYTES <= 232448, "dK/dV block over 227 KB of shared memory");
};

template <int HD>
struct QLayout {                  // dQ block
  static constexpr int NP = HD / 64;
  static constexpr int QT = NP * PANEL;           // Q (or dO) tile: 64 rows
  static constexpr int KT = NP * PANEL;           // K (or V) tile: 64 keys
  static constexpr int NST = 4;                   // ring stages
  static constexpr int Q_OFF = 0;                 // [NWG] Q, a warpgroup each
  static constexpr int O_OFF = NWG * QT;          // [NWG] dO
  static constexpr int K_OFF = 2 * NWG * QT;      // [NST] K
  static constexpr int V_OFF = K_OFF + NST * KT;  // [NST] V
  static constexpr int L_OFF = V_OFF + NST * KT;  // [NWG][64] lse
  static constexpr int D_OFF = L_OFF + NWG * ROWS * 4;     // [NWG][64] D
  static constexpr int BAR_OFF = D_OFF + NWG * ROWS * 4;   // q, full, empty
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * NST) + 1024;
  static_assert(BYTES <= 232448, "dQ block over 227 KB of shared memory");
};

// dK, dV (either or both): one block per KEYS keys of one (batch, kv head);
// warpgroup 0 is the producer (lane 0 of its first warp issues every TMA
// load, its 32 lanes copy lse and D), each consumer warpgroup owns 64 of
// the keys.  K and V stay in shared memory; Q, dO, lse and D come through a
// ring of NST stages, one query tile (npos positions, all gp heads:
// npos*gp <= 64 packed rows) a stage, for every tile on or below the
// diagonal.
template <int HD, bool DK, bool DV>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_wg_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ lse, const float* __restrict__ D,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int seq, int kvp, int gp, int npos, float scale_log2,
               float scale) {
  using L = KvLayout<HD>;
  constexpr int NP = L::NP, NST = L::NST;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const unsigned bar_kv = base + L::BAR_OFF;
  const unsigned bar_full = bar_kv + 8, bar_empty = bar_kv + 8 * (1 + NST);
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * KEYS;
  const int tile_rows = npos * gp;
  const int t_first = k0 / npos, t_end = (seq + npos - 1) / npos;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full + 8 * s, 33);        // TMA and 32 lanes' copies
      mbar_init(bar_empty + 8 * s, 4 * NWG);  // every consumer warp
    }
  }
  if (tile_rows < ROWS) zero_tails(sm + L::Q_OFF, 2 * NST * NP, tile_rows);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (wgi == 0) {                             // producer: warp 0
    producer_regs();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const int rows = seq * gp;
    const long long st_base = (long long)(b * kvp + h) * rows;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * L::KT);
      for (int p = 0; p < NP; ++p)
        for (int c = 0; c < NWG; ++c) {
          const unsigned off = (p * NWG + c) * PANEL;
          tma_4d(base + L::K_OFF + off, &tk, bar_kv, 64 * p, h, k0 + 64 * c,
                 b);
          tma_4d(base + L::V_OFF + off, &tv, bar_kv, 64 * p, h, k0 + 64 * c,
                 b);
        }
    }
    for (int t = t_first, i = 0; t < t_end; ++t, ++i) {
      const int s = i % NST;
      mbar_wait(bar_empty + 8 * s, ((i / NST) & 1) ^ 1);
      const unsigned full = bar_full + 8 * s;
      if (lane == 0) {
        mbar_expect_tx(full, 2 * NP * tile_rows * 128);
        for (int p = 0; p < NP; ++p) {
          tma_5d(base + L::Q_OFF + s * L::QT + p * PANEL, &tq, full, 64 * p,
                 0, h, t * npos, b);
          tma_5d(base + L::O_OFF + s * L::QT + p * PANEL, &tdo, full, 64 * p,
                 0, h, t * npos, b);
        }
      }
      copy_rows(base + L::L_OFF + s * ROWS * 4, base + L::D_OFF + s * ROWS * 4,
                lse, D, st_base, t * tile_rows, tile_rows, rows, lane);
      arrive_on_copies(full);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  consumer_regs();
  const int w = wgi - 1;
  const int tid = threadIdx.x - 128 * wgi;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int kw0 = k0 + 64 * w;                // the warpgroup's first key
  const int key_a = kw0 + 16 * warp + gid, key_b = key_a + 8;
  const unsigned k_base = base + L::K_OFF + w * PANEL;
  const unsigned v_base = base + L::V_OFF + w * PANEL;
  float dka[DK ? HD / 2 : 1], dva[DV ? HD / 2 : 1];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    if constexpr (DK) dka[i] = 0.f;
    if constexpr (DV) dva[i] = 0.f;
  }
  mbar_wait(bar_kv, 0);
  // one lane of each consumer warp releases a stage once the warp's
  // products on it have retired and its reads of lse and D are done
  auto release = [&](int st_) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st_);
  };

  if (w == NWG - 1) turn_pass(w);  // warpgroup 0 goes first
  for (int t = t_first, i = 0; t < t_end; ++t, ++i) {
    const int s = i % NST;
    mbar_wait(bar_full + 8 * s, (i / NST) & 1);
    const int p_lo = t * npos;
    if (kw0 >= seq || p_lo + npos - 1 < kw0) {   // no row sees these keys
      turn_wait(w);               // the turns go on, two a tile
      turn_pass(w);
      turn_wait(w);
      turn_pass(w);
      release(s);
      continue;
    }
    unsigned q_sm = base + L::Q_OFF + s * L::QT;
    unsigned o_sm = base + L::O_OFF + s * L::QT;
    unsigned k_sm = k_base, v_sm = v_base;
    opaque(q_sm, o_sm, k_sm, v_sm);
    const float* ls = reinterpret_cast<const float*>(sm + L::L_OFF) +
                      s * ROWS;
    const float* ds = reinterpret_cast<const float*>(sm + L::D_OFF) +
                      s * ROWS;
    // S^T = K Q^T (and for dK, dP^T = V dO^T): 64 keys x 64 packed rows
    float st[32], dpt[DK ? 32 : 1];
    turn_wait(w);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const unsigned a = (kk >> 2) * NWG * PANEL + (kk & 3) * 32;
      const unsigned bq = (kk >> 2) * PANEL + (kk & 3) * 32;
      wgmma_ss_n64(st, desc(k_sm + a, 16), desc(q_sm + bq, 16), kk > 0);
    }
    wg_commit();
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const unsigned a = (kk >> 2) * NWG * PANEL + (kk & 3) * 32;
        const unsigned bq = (kk >> 2) * PANEL + (kk & 3) * 32;
        wgmma_ss_n64(dpt, desc(v_sm + a, 16), desc(o_sm + bq, 16), kk > 0);
      }
      wg_commit();
      turn_pass(w);
      wg_wait<1>();               // S^T done; dP^T runs on
    } else {
      turn_pass(w);
      wg_wait<0>();
    }
    keep(st);
    // P^T from lse; element (key_a | key_b, row 8j + 2tig + e).  Only tiles
    // that cross the diagonal are masked: a row past the tile's packed rows
    // or past the sequence has zero Q and dO rows and a zero lse and D, so
    // its P is 1 and its products add exactly 0
    // (one branch for the tile, none inside the loops, so the exponentials
    // of all 32 elements can be in flight together)
    if (p_lo < kw0 + 63) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * tig + e;
          const float l2 = ls[col] * LOG2E;
          const int pos = p_lo + col / gp;
          const float pa = ex2(fmaf(st[4 * j + e], scale_log2, -l2));
          const float pb = ex2(fmaf(st[4 * j + 2 + e], scale_log2, -l2));
          st[4 * j + e] = key_a > pos ? 0.f : pa;    // set to 0, never
          st[4 * j + 2 + e] = key_b > pos ? 0.f : pb;  // multiplied
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = ls[8 * j + 2 * tig + e] * LOG2E;
          st[4 * j + e] = ex2(fmaf(st[4 * j + e], scale_log2, -l2));
          st[4 * j + 2 + e] = ex2(fmaf(st[4 * j + 2 + e], scale_log2, -l2));
        }
    }
    if constexpr (DK) {           // dS^T = P^T (dP^T - D)
      wg_wait<0>();
      keep(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dd = ds[8 * j + 2 * tig + e];
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dd);
          dpt[4 * j + 2 + e] = st[4 * j + 2 + e] * (dpt[4 * j + 2 + e] - dd);
        }
    }
    // dV += P^T dO and dK += dS^T Q, 16 packed rows a k-step, P^T and dS^T
    // as bf16 A fragments; dO and Q are MN-major B operands (the head dim
    // runs along their rows)
    unsigned pf[4][4], sf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (DV) frag(pf[kk], st, kk);
      if constexpr (DK) frag(sf[kk], dpt, kk);
    }
    turn_wait(w);
    wg_fence();
    if constexpr (DV) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        RsOp<HD>::run(dva, pf[kk], desc(o_sm + kk * 2048, PANEL));
    }
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        RsOp<HD>::run(dka, sf[kk], desc(q_sm + kk * 2048, PANEL));
    }
    wg_commit();
    turn_pass(w);
    wg_wait<0>();
    if constexpr (DV) keep(dva);
    if constexpr (DK) keep(dka);
    release(s);
  }
  if (w == 0) turn_wait(w);       // the turn passed after the last tile

  // element (key_a | key_b, dim 8j + 2tig + e) is dka[4j + 2*half + e]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_a + 8 * half;
    if (key >= seq) continue;
    const long long off = ((long long)(b * seq + key) * kvp + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int dim = 8 * j + 2 * tig;
      if constexpr (DK)
        *reinterpret_cast<unsigned*>(dk + off + dim) =
            pack(dka[4 * j + 2 * half] * scale,
                 dka[4 * j + 2 * half + 1] * scale);
      if constexpr (DV)
        *reinterpret_cast<unsigned*>(dv + off + dim) =
            pack(dva[4 * j + 2 * half], dva[4 * j + 2 * half + 1]);
    }
  }
}

// dQ: one block per NWG*npos positions (a tile of npos*gp <= 64 packed rows
// a consumer warpgroup) of one (batch, kv head); the producer loads the Q
// and dO tiles with their lse and D once, then streams the K and V tiles at
// or below the block's last position through the ring.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_wg_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const float* __restrict__ lse, const float* __restrict__ D,
             __nv_bfloat16* __restrict__ dq, int seq, int kvp, int gp,
             int npos, float scale_log2, float scale) {
  using L = QLayout<HD>;
  constexpr int NP = L::NP, NST = L::NST;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const unsigned bar_q = base + L::BAR_OFF;
  const unsigned bar_full = bar_q + 8, bar_empty = bar_q + 8 * (1 + NST);
  const int h = blockIdx.y, b = blockIdx.z;
  const int p0 = (gridDim.x - 1 - blockIdx.x) * NWG * npos;   // long first
  const int tile_rows = npos * gp;
  const int p_hi = min(p0 + NWG * npos, seq) - 1;  // the block's last row
  const int ntiles = p_hi / BK + 1;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 33);                     // TMA and 32 lanes' copies
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NWG);
    }
  }
  if (tile_rows < ROWS) zero_tails(sm + L::Q_OFF, 2 * NWG * NP, tile_rows);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (wgi == 0) {                             // producer: warp 0
    producer_regs();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const int rows = seq * gp;
    const long long st_base = (long long)(b * kvp + h) * rows;
    if (lane == 0) {
      mbar_expect_tx(bar_q, 2 * NWG * NP * tile_rows * 128);
      for (int w = 0; w < NWG; ++w)
        for (int p = 0; p < NP; ++p) {
          tma_5d(base + L::Q_OFF + w * L::QT + p * PANEL, &tq, bar_q, 64 * p,
                 0, h, p0 + w * npos, b);
          tma_5d(base + L::O_OFF + w * L::QT + p * PANEL, &tdo, bar_q,
                 64 * p, 0, h, p0 + w * npos, b);
        }
    }
    for (int w = 0; w < NWG; ++w)
      copy_rows(base + L::L_OFF + w * ROWS * 4, base + L::D_OFF + w * ROWS * 4,
                lse, D, st_base, (p0 + w * npos) * gp, tile_rows, rows, lane);
    arrive_on_copies(bar_q);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (lane != 0) return;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % NST;
      mbar_wait(bar_empty + 8 * s, ((t / NST) & 1) ^ 1);
      const unsigned full = bar_full + 8 * s;
      mbar_expect_tx(full, 2 * L::KT);
      for (int p = 0; p < NP; ++p) {
        tma_4d(base + L::K_OFF + s * L::KT + p * PANEL, &tk, full, 64 * p, h,
               t * BK, b);
        tma_4d(base + L::V_OFF + s * L::KT + p * PANEL, &tv, full, 64 * p, h,
               t * BK, b);
      }
    }
    return;
  }

  consumer_regs();
  const int w = wgi - 1;
  const int tid = threadIdx.x - 128 * wgi;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int pw = p0 + w * npos;               // the warpgroup's first position
  const int p_hi_w = min(pw + npos, seq) - 1;
  const int ra = 16 * warp + gid, rb = ra + 8;   // rows in the tile
  // a row past the tile's packed rows or the sequence gets position seq
  // (never stored; the causal mask needs only valid rows)
  const int pos_a = ra < tile_rows ? pw + (gp == 1 ? ra : ra / gp) : seq;
  const int pos_b = rb < tile_rows ? pw + (gp == 1 ? rb : rb / gp) : seq;
  const unsigned q_base = base + L::Q_OFF + w * L::QT;
  const unsigned o_base = base + L::O_OFF + w * L::QT;
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
  mbar_wait(bar_q, 0);
  const float* ls = reinterpret_cast<const float*>(sm + L::L_OFF) + w * ROWS;
  const float* ds = reinterpret_cast<const float*>(sm + L::D_OFF) + w * ROWS;
  const float l2a = ls[ra] * LOG2E, l2b = ls[rb] * LOG2E;
  const float da = ds[ra], db = ds[rb];

  auto release = [&](int st_) {   // as in the dK/dV pass
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st_);
  };

  if (w == NWG - 1) turn_pass(w);  // as in the dK/dV pass
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NST;
    mbar_wait(bar_full + 8 * s, (t / NST) & 1);
    const int kt0 = t * BK;
    if (pw >= seq || kt0 > p_hi_w) {           // keys no row here sees
      turn_wait(w);
      turn_pass(w);
      turn_wait(w);
      turn_pass(w);
      release(s);
      continue;
    }
    unsigned k_sm = base + L::K_OFF + s * L::KT;
    unsigned v_sm = base + L::V_OFF + s * L::KT;
    unsigned q_sm = q_base, o_sm = o_base;
    opaque(q_sm, o_sm, k_sm, v_sm);
    // S = Q K^T and dP = dO V^T: 64 packed rows x 64 keys
    float sc[32], dp[32];
    turn_wait(w);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const unsigned o = (kk >> 2) * PANEL + (kk & 3) * 32;
      wgmma_ss_n64(sc, desc(q_sm + o, 16), desc(k_sm + o, 16), kk > 0);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const unsigned o = (kk >> 2) * PANEL + (kk & 3) * 32;
      wgmma_ss_n64(dp, desc(o_sm + o, 16), desc(v_sm + o, 16), kk > 0);
    }
    wg_commit();
    turn_pass(w);
    wg_wait<1>();                 // S done; dP runs on
    keep(sc);
    if (kt0 + BK - 1 > pw) {      // a key past the first row: masked
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt0 + 8 * j + 2 * tig + e;
          const float pa = ex2(fmaf(sc[4 * j + e], scale_log2, -l2a));
          const float pb = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -l2b));
          sc[4 * j + e] = key > pos_a ? 0.f : pa;
          sc[4 * j + 2 + e] = key > pos_b ? 0.f : pb;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -l2a));
          sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -l2b));
        }
    }
    wg_wait<0>();
    keep(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - da);
        dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - db);
      }
    // dQ += dS K, 16 keys a k-step; K is an MN-major B operand
    unsigned sf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag(sf[kk], dp, kk);
    turn_wait(w);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      RsOp<HD>::run(dqa, sf[kk], desc(k_sm + kk * 2048, PANEL));
    wg_commit();
    turn_pass(w);
    wg_wait<0>();
    keep(dqa);
    release(s);
  }
  if (w == 0) turn_wait(w);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    const int pos = half ? pos_b : pos_a;
    if (pos >= seq) continue;
    const int g = r - (pos - pw) * gp;
    __nv_bfloat16* row =
        dq + (((long long)(b * seq + pos) * kvp + h) * gp + g) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int dim = 8 * j + 2 * tig;
      *reinterpret_cast<unsigned*>(row + dim) =
          pack(dqa[4 * j + 2 * half] * scale,
               dqa[4 * j + 2 * half + 1] * scale);
    }
  }
}

// ------------------------------------------------------------ host side
// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// libcuda at link time)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over `rank` dims (innermost first, strides in bytes of dims
// 1..rank-1); out-of-range elements of a box read as zeros
bool tensor_map(CUtensorMap* m, CUtensorMapDataType type, int rank,
                const void* ptr, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn != nullptr &&
         fn(m, type, (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool DK, bool DV>
int launch_kv(const CUtensorMap& tq, const CUtensorMap& tdo,
              const CUtensorMap& tk, const CUtensorMap& tv, const float* lse,
              const float* D, void* dk, void* dv, int B, int S, int kvp, int gp,
              int npos, float scale_log2, float scale, cudaStream_t stream) {
  const int err = set_smem(dkdv_wg_kernel<HD, DK, DV>, KvLayout<HD>::BYTES);
  if (err) return err;
  dim3 grid((S + KEYS - 1) / KEYS, kvp, B);
  dkdv_wg_kernel<HD, DK, DV><<<grid, THREADS, KvLayout<HD>::BYTES, stream>>>(
      tq, tdo, tk, tv, lse, D, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, kvp,
      gp, npos, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const void* dout, const void* q, const void* k, const void* v,
               const float* lse, const float* D, void* dq, void* dk, void* dv,
               int B, int S, int kvp, int gp, cudaStream_t stream) {
  if (gp < 1 || gp > ROWS) return (int)cudaErrorInvalidValue;
  const int npos = ROWS / gp;
  const cuuint64_t e = 2;                      // bytes of a bf16
  // q, do [B, S, KVp, gp, hd] as (hd, gp, KVp, S, B); a box is npos whole
  // positions of one kv head: npos*gp packed rows of 64 dims
  const cuuint64_t qdims[5] = {(cuuint64_t)HD, (cuuint64_t)gp,
                               (cuuint64_t)kvp, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t qstr[4] = {HD * e, gp * HD * e, kvp * gp * HD * e,
                              (cuuint64_t)S * kvp * gp * HD * e};
  const cuuint32_t qbox[5] = {64, (cuuint32_t)gp, 1, (cuuint32_t)npos, 1};
  // k, v [B, S, KVp, hd] as (hd, KVp, S, B); a box is 64 keys of 64 dims
  const cuuint64_t kdims[4] = {(cuuint64_t)HD, (cuuint64_t)kvp,
                               (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kstr[3] = {HD * e, kvp * HD * e,
                              (cuuint64_t)S * kvp * HD * e};
  const cuuint32_t kbox[4] = {64, 1, 64, 1};
  CUtensorMap tq, tdo, tk, tv;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&tq, bf, 5, q, qdims, qstr, qbox, sw) ||
      !tensor_map(&tdo, bf, 5, dout, qdims, qstr, qbox, sw) ||
      !tensor_map(&tk, bf, 4, k, kdims, kstr, kbox, sw) ||
      !tensor_map(&tv, bf, 4, v, kdims, kstr, kbox, sw))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)HD);
  const float scale_log2 = LOG2E * scale;
  int err;
  if constexpr (HD == 64) {
    err = launch_kv<HD, true, true>(tq, tdo, tk, tv, lse, D, dk, dv, B, S,
                                    kvp, gp, npos, scale_log2, scale, stream);
  } else {
    // at hd 128 a warpgroup's dK and dV accumulators (64 + 64 registers a
    // thread) leave too few for S^T and dP^T: dV, then dK, each forming S^T
    err = launch_kv<HD, false, true>(tq, tdo, tk, tv, lse, D, dk, dv, B, S,
                                     kvp, gp, npos, scale_log2, scale, stream);
    if (err) return err;
    err = launch_kv<HD, true, false>(tq, tdo, tk, tv, lse, D, dk, dv, B, S,
                                     kvp, gp, npos, scale_log2, scale, stream);
  }
  if (err) return err;
  err = set_smem(dq_wg_kernel<HD>, QLayout<HD>::BYTES);
  if (err) return err;
  dim3 q_grid((S + NWG * npos - 1) / (NWG * npos), kvp, B);
  dq_wg_kernel<HD><<<q_grid, THREADS, QLayout<HD>::BYTES, stream>>>(
      tq, tdo, tk, tv, lse, D, (__nv_bfloat16*)dq, S, kvp, gp, npos,
      scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" int flash_attention_bwd_bf16(const void* dout, const void* q,
                                        const void* k, const void* v,
                                        const void* out, const void* lse,
                                        void* D, void* dq, void* dk, void* dv,
                                        int B, int S, int kvp, int gp, int hd,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* d = (float*)D;
#define BWD_TC(HDP) \
  launch_bwd_tc<HDP>(dout, q, k, v, out, l, d, dq, dk, dv, B, S, kvp, gp, hd, st)
  if (hd <= 16) return BWD_TC(16);
  if (hd <= 32) return BWD_TC(32);
  if (hd <= 64) return BWD_TC(64);
  if (hd <= 128) return BWD_TC(128);
  if (hd <= 256) return BWD_TC(256);
#undef BWD_TC
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_bf16_wgmma(
    const void* dout, const void* q, const void* k, const void* v,
    const void* out, const void* lse, void* D, void* dq, void* dk, void* dv,
    int B, int S, int kvp, int gp, int hd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* d = (float*)D;
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  int e = launch_row_dot<__nv_bfloat16>(dout, out, d, B, S, kvp, gp, hd, st);
  if (e) return e;
  if (hd == 64)
    return wg::launch_bwd<64>(dout, q, k, v, l, d, dq, dk, dv, B, S, kvp, gp,
                              st);
  return wg::launch_bwd<128>(dout, q, k, v, l, d, dq, dk, dv, B, S, kvp, gp,
                             st);
}

extern "C" int flash_attention_bwd_f32(const void* dout, const void* q,
                                       const void* k, const void* v,
                                       const void* out, const void* lse,
                                       void* D, void* dq, void* dk, void* dv,
                                       int B, int S, int kvp, int gp, int hd,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* d = (float*)D;
#define BWD_F32(PER) \
  launch_bwd_f32<PER>(dout, q, k, v, out, l, d, dq, dk, dv, B, S, kvp, gp, hd, st)
  if (hd <= 64) return BWD_F32(4);
  if (hd <= 128) return BWD_F32(8);
  if (hd <= 256) return BWD_F32(16);
#undef BWD_F32
  return (int)cudaErrorInvalidValue;
}
