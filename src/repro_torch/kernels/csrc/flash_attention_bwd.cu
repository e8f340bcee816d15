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
// Three launches, no floating-point atomics (every output element is summed
// by one thread in a fixed order), so two runs on the same inputs are
// bit-equal, which the fault-tolerant replay of a training run relies on.
//
// bf16 (every plan that trains on the card), on the bf16 tensor cores with
// mma.sync m16n8k16 and f32 accumulators.  What bounds it: the 2.5x of the
// forward's tensor-core operations (five S^2/2 x hd products instead of
// two), and the shared-memory reads that feed them.  Design (FA2's):
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
