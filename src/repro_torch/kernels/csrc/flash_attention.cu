// Causal flash attention (prefill) for Hopper (sm_90a), grouped-query layout.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py, body _flash_kernel).  Contract:
//   q    [B, S, KVp, gp, hd]   -- gp query heads share each kv head
//   k, v [B, S, KVp, hd]
//   out  [B, S, KVp, gp, hd]
//   lse  [B, KVp, S*gp] f32, optional (null on the serving path): the natural
//        log-sum-exp of each packed query row's scaled scores, which the
//        backward (flash_attention_bwd.cu) reads to rebuild P
// bf16 or f32 in (q, k, v and out alike), f32 inside: scores q.k / sqrt(hd),
// query s sees keys 0..s, online softmax, out = acc / max(l, 1e-30).
//
// The query rows of one (batch, kv head) are packed as r = s*gp + g, so the
// gp heads that share a kv head share each K/V tile (no repeated KV heads)
// and row r sees keys 0..r/gp.  Ragged S and hd are masked: keys past S and
// dims past hd are zero-filled in shared memory and keys past a row's
// position get a finite -1e30 score before the row max; rows past S*gp are
// never written.
//
// bf16 (every plan that runs on the card): flash_tc_kernel, on the bf16
// tensor cores.  What bounds it: at the admission round (Qwen3 B 8, S 32;
// Jamba B 8, S 128) a few MB of bytes and the launch; at a long prefill the
// 4*S^2/2*hd flops per query head on the tensor cores, and the shared-memory
// reads that feed them.  Design (FA2's shape, mma.sync rather than wgmma):
//   * a block of 8 warps owns 128 packed query rows, 16 per warp, and walks
//     the 64-key K/V tiles at or below its last row's position, the blocks
//     of the longest rows launched first;
//   * K/V tiles stream through a 3-stage cp.async ring in shared memory (2
//     stages at hd 256), one barrier per tile, so two tiles load while one
//     is multiplied; rows are padded with zeros to a power-of-two head dim
//     and their 16-byte chunks XOR-swizzled, so every ldmatrix is free of
//     bank conflicts;
//   * S = Q.K^T is mma.sync.m16n8k16 bf16 -> f32: Q fragments by ldmatrix
//     (kept in registers up to hd 128), K rows as the K-major B operand;
//   * the online softmax runs on the accumulators (a quad shuffle for the
//     row max and, once at the end, the row sum); the 1/sqrt(hd) scale, with
//     log2 e, multiplies the f32 scores inside the FFMA that feeds ex2, not
//     q, so q is rounded only once;
//   * O += P.V takes P from the S accumulators as bf16 A fragments in
//     registers and V through ldmatrix.trans.  P is split into hi = bf16(p)
//     and lo = bf16(p - hi), two products: a bf16 P alone (8 bits) moves a
//     row of few keys by up to 2^-9 |v|, past the 2^-10 floor of the
//     tolerance against the f32 plain version; hi + lo carries 16 bits;
//   * 16-key chunks wholly above a warp's rows are skipped.
//
// f32 (only f32 plans, none of which runs on the card in the smoke run):
// flash_f32_kernel, on CUDA cores, unchanged -- tensor cores would take f32
// only as TF32, which keeps 10 mantissa bits and would change the numbers
// the f32 plans promise.  A block of 64 rows (8 warps x 8 rows) walks
// 32-key tiles; lane j scores key j for the warp's 8 rows, softmax
// statistics are warp reductions, each V row is read once for 8 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// ================================================================ bf16
constexpr int TC_WARPS = 8;              // 16 query rows each
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_ROWS = TC_WARPS * 16;   // packed query rows per block
constexpr int TC_BK = 64;                // keys per K/V tile
// K/V tiles in flight in shared memory: 3 up to hd 128, 2 at hd 256
// (128 + 6 x 64 rows of 512 bytes would not fit)
__host__ __device__ constexpr int tc_stages(int hdp) {
  return hdp <= 128 ? 3 : 2;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte slot of chunk c of row r in a [rows][HDP] bf16 tile: chunks are
// XOR-swizzled so the 8 rows of one ldmatrix matrix land in 8 distinct
// 16-byte bank groups.
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

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) -> bf16 pair hi and the pair of what hi leaves out, lo
__device__ __forceinline__ void split_pair(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// 16 bytes of one row (8 bf16 from dim 8c), zero past hd or where !ok.
// vec: hd % 8 == 0 and 16-byte aligned rows, so cp.async zero-fills.
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

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int seq, int kvp, int gp, int hd, float scale_log2, int vec) {
  constexpr int CH = HDP / 8;        // 16-byte chunks per row
  constexpr int KS = HDP / 16;       // k16 steps of Q.K^T
  constexpr int NT = HDP / 8;        // n8 tiles of O
  constexpr bool Q_IN_REGS = HDP <= 128;
  constexpr int STAGES = tc_stages(HDP);
  extern __shared__ uint4 smem[];
  uint4* qs = smem;                          // [TC_ROWS][CH]
  uint4* ks = qs + TC_ROWS * CH;             // [STAGES][TC_BK][CH]
  uint4* vs = ks + STAGES * TC_BK * CH;      // [STAGES][TC_BK][CH]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int rows = seq * gp;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * TC_ROWS;  // long rows first
  const long long q_pos = (long long)kvp * gp * hd;        // one position of q
  const long long q_base = ((long long)b * seq * kvp + h) * gp * hd;
  const long long kv_pos = (long long)kvp * hd;
  const long long kv_base = ((long long)b * seq * kvp + h) * hd;
  const bool vc = vec != 0;

  for (int i = tid; i < TC_ROWS * CH; i += TC_THREADS) {
    const int rl = i / CH, c = i % CH, r = r0 + rl;
    const int s = r / gp, g = r - s * gp;
    stage16(&qs[slot<HDP>(rl, c)], q + q_base + s * q_pos + (long long)g * hd,
            c, hd, r < rows, vc, q);
  }
  auto stage_kv = [&](int t, int buf) {
    uint4* kb = ks + buf * TC_BK * CH;
    uint4* vb = vs + buf * TC_BK * CH;
    for (int i = tid; i < TC_BK * CH; i += TC_THREADS) {
      const int j = i / CH, c = i % CH, p = t * TC_BK + j;
      const long long off = kv_base + (long long)p * kv_pos;
      stage16(&kb[slot<HDP>(j, c)], k + off, c, hd, p < seq, vc, k);
      stage16(&vb[slot<HDP>(j, c)], v + off, c, hd, p < seq, vc, v);
    }
  };
  const int last = min(r0 + TC_ROWS, rows) - 1;   // the block's last row
  const int ntiles = last / gp / TC_BK + 1;         // tiles at or below it
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {        // q rides with tile 0
    if (st < ntiles) stage_kv(st, st);
    asm volatile("cp.async.commit_group;\n");
  }
  const int wr0 = r0 + warp * 16;                   // the warp's first row
  const int wpos_lo = wr0 / gp;
  const int wpos_hi = wr0 < rows ? min(wr0 + 15, rows - 1) / gp : -1;
  const int pos_a = (wr0 + gid) / gp, pos_b = (wr0 + gid + 8) / gp;

  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float o[NT][4];
#pragma unroll
  for (int d = 0; d < NT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  unsigned qf[Q_IN_REGS ? KS : 1][4];

  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
    __syncthreads();      // tile t landed; every warp is done with t - 1
    if (t + STAGES - 1 < ntiles)
      stage_kv(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    asm volatile("cp.async.commit_group;\n");
    const int k0 = t * TC_BK;
    if (k0 <= wpos_hi) {
      const uint4* kb = ks + (t % STAGES) * TC_BK * CH;
      const uint4* vb = vs + (t % STAGES) * TC_BK * CH;
      // A fragments of the warp's 16 rows: matrices (rows 0-7 | 8-15) x
      // (dims 16kk..+7 | +8..+15)
      const int qrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      if (Q_IN_REGS && t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qf[Q_IN_REGS ? kk : 0],
                  &qs[slot<HDP>(qrow, 2 * kk + (lane >> 4))]);
      }
      // S = Q.K^T for the 64 keys: n8 tile j holds keys 8j..8j+7
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        unsigned a[4];
        if (Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[Q_IN_REGS ? kk : 0][e];
        } else {
          ldsm_x4(a, &qs[slot<HDP>(qrow, 2 * kk + (lane >> 4))]);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (k0 + 16 * p > wpos_hi) continue;     // keys no row here sees
          unsigned bk[4];
          const int key = 16 * p + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(bk, &kb[slot<HDP>(key, 2 * kk + ((lane >> 3) & 1))]);
          mma_bf16(s[2 * p], a, bk[0], bk[1]);
          mma_bf16(s[2 * p + 1], a, bk[2], bk[3]);
        }
      }
      // online softmax on the raw f32 scores (the scale is positive, so
      // the row max commutes with it); p = 2^(s * c - m * c) with
      // c = log2(e) / sqrt(hd) in one FFMA.  Rows gid (a) and gid + 8 (b).
      const bool diag = k0 + TC_BK - 1 > wpos_lo;
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * j + 2 * tig + e;
          if (diag && key > pos_a) s[j][e] = NEG_INF;
          if (diag && key > pos_b) s[j][2 + e] = NEG_INF;
          mx_a = fmaxf(mx_a, s[j][e]);
          mx_b = fmaxf(mx_b, s[j][2 + e]);
        }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, o_));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, o_));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = ex2((m_a - mn_a) * scale_log2);
      const float corr_b = ex2((m_b - mn_b) * scale_log2);
      m_a = mn_a;
      m_b = mn_b;
      const float off_a = -mn_a * scale_log2, off_b = -mn_b * scale_log2;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // a masked key: 2^(-1e30 c - m c) = 0, as key 0 keeps m finite
          s[j][e] = ex2(fmaf(s[j][e], scale_log2, off_a));
          s[j][2 + e] = ex2(fmaf(s[j][2 + e], scale_log2, off_b));
          sum_a += s[j][e];
          sum_b += s[j][2 + e];
        }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int d = 0; d < NT; ++d) {
        o[d][0] *= corr_a;
        o[d][1] *= corr_a;
        o[d][2] *= corr_b;
        o[d][3] *= corr_b;
      }
      // O += P.V, 16 keys at a time, P as hi + lo bf16 A fragments
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (k0 + 16 * c > wpos_hi) continue;
        unsigned hi[4], lo[4];
        split_pair(s[2 * c][0], s[2 * c][1], hi[0], lo[0]);
        split_pair(s[2 * c][2], s[2 * c][3], hi[1], lo[1]);
        split_pair(s[2 * c + 1][0], s[2 * c + 1][1], hi[2], lo[2]);
        split_pair(s[2 * c + 1][2], s[2 * c + 1][3], hi[3], lo[3]);
        const int key = 16 * c + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int d = 0; d < NT; d += 2) {
          unsigned bv[4];
          ldsm_x4_t(bv, &vb[slot<HDP>(key, d + (lane >> 4))]);
          mma_bf16(o[d], hi, bv[0], bv[1]);
          mma_bf16(o[d], lo, bv[0], bv[1]);
          mma_bf16(o[d + 1], hi, bv[2], bv[3]);
          mma_bf16(o[d + 1], lo, bv[2], bv[3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n");
  if (wpos_hi < 0) return;        // the warp's rows all lie past S*gp

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(FULL, l_a, o_);
    l_b += __shfl_xor_sync(FULL, l_b, o_);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  if (lse != nullptr && tig == 0) {
    // lse = m / sqrt(hd) + ln(l) = (m * c + log2(l)) * ln 2
    float* row_lse = lse + ((long long)b * kvp + h) * rows;
    if (wr0 + gid < rows)
      row_lse[wr0 + gid] = (m_a * scale_log2 + log2f(l_a)) *
                           0.6931471805599453f;
    if (wr0 + gid + 8 < rows)
      row_lse[wr0 + gid + 8] = (m_b * scale_log2 + log2f(l_b)) *
                               0.6931471805599453f;
  }
  // stage the warp's 16 output rows in its own rows of qs, then write
  // whole 16-byte chunks
  const int ra = warp * 16 + gid, rb = ra + 8;
#pragma unroll
  for (int d = 0; d < NT; ++d) {
    reinterpret_cast<unsigned*>(&qs[slot<HDP>(ra, d)])[tig] =
        as_u32(__floats2bfloat162_rn(o[d][0] * inv_a, o[d][1] * inv_a));
    reinterpret_cast<unsigned*>(&qs[slot<HDP>(rb, d)])[tig] =
        as_u32(__floats2bfloat162_rn(o[d][2] * inv_b, o[d][3] * inv_b));
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int rl = i / CH, c = i % CH, r = wr0 + rl;
    if (r >= rows || 8 * c >= hd) continue;
    const int s = r / gp, g = r - s * gp;
    __nv_bfloat16* dst = out + q_base + s * q_pos + (long long)g * hd + 8 * c;
    const uint4 val = qs[slot<HDP>(warp * 16 + rl, c)];
    if (vc) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
      for (int x = 0; x < 8 && 8 * c + x < hd; ++x) dst[x] = e[x];
    }
  }
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int S, int kvp, int gp, int hd,
              cudaStream_t stream) {
  const size_t smem =
      (size_t)(TC_ROWS + 2 * tc_stages(HDP) * TC_BK) * HDP * 2;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = hd % 8 == 0 &&
                  (((size_t)q | (size_t)k | (size_t)v | (size_t)out) % 16) == 0;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  dim3 grid((S * gp + TC_ROWS - 1) / TC_ROWS, kvp, B);
  flash_tc_kernel<HDP><<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, lse, S, kvp, gp, hd,
      scale_log2, vec);
  return (int)cudaGetLastError();
}

// ================================================================ f32
constexpr int THREADS = 256;            // 8 warps
constexpr int RPW = 8;                  // query rows per warp
constexpr int ROWS = THREADS / 32 * RPW;  // 64 query rows per block
constexpr int BK = 32;                  // keys per tile, one per lane

// Shared-memory row strides: q and K rows padded to whole float4s (zeros
// past hd), K rows by 4 more so the lanes' 16-byte loads of 8 consecutive
// rows fall in distinct banks.
__host__ __device__ constexpr int q_stride(int hd) { return (hd + 3) / 4 * 4; }
__host__ __device__ constexpr int k_stride(int hd) { return q_stride(hd) + 4; }

template <int HDC>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int seq, int kvp, int gp, int hd) {
  extern __shared__ float4 smem4[];
  const int QS = q_stride(hd), KS = k_stride(hd);
  float* qs = reinterpret_cast<float*>(smem4);  // [ROWS, QS]  q / sqrt(hd)
  float* ks = qs + ROWS * QS;                   // [BK, KS]
  float* vs = ks + BK * KS;                     // [BK, hd]
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = seq * gp;             // query rows of this (batch, kv head)
  const int r0 = blockIdx.x * ROWS;
  const int w0 = r0 + warp * RPW;        // the warp's first row
  const long long q_stride_s = (long long)kvp * gp * hd;   // one position
  const long long q_base = ((long long)b * seq * kvp + h) * gp * hd;
  const long long kv_stride_s = (long long)kvp * hd;
  const long long kv_base = ((long long)b * seq * kvp + h) * hd;
  const float rsq = sqrtf((float)hd);

  for (int i = tid; i < ROWS * QS; i += THREADS) {
    const int rl = i / QS, d = i - rl * QS, r = r0 + rl;
    float x = 0.f;
    if (r < rows && d < hd) {
      const int s = r / gp, g = r - s * gp;
      x = q[q_base + s * q_stride_s + (long long)g * hd + d] / rsq;
    }
    qs[i] = x;
  }

  float m[RPW], l[RPW], acc[RPW][HDC];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HDC; ++c) acc[i][c] = 0.f;
  }

  const int last = min(r0 + ROWS, rows) - 1;     // the block's last row
  const int ntiles = last / gp / BK + 1;          // tiles at or below it
  const int pos_hi = (w0 + RPW - 1) / gp;         // the warp's last position
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // q staged / previous tile consumed
    for (int i = tid; i < BK * QS; i += THREADS) {
      const int j = i / QS, d = i - j * QS, p = k0 + j;
      float kx = 0.f;
      if (p < seq && d < hd) {
        const long long off = kv_base + p * kv_stride_s + d;
        kx = k[off];
        vs[j * hd + d] = v[off];
      } else if (d < hd) {
        vs[j * hd + d] = 0.f;
      }
      ks[j * KS + d] = kx;
    }
    __syncthreads();
    if (k0 > pos_hi) continue;         // the warp's rows all lie above

    // scores: lane j against key k0 + j, for the warp's RPW rows
    float sc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sc[i] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(ks + lane * KS);
    const float4* q4 = reinterpret_cast<const float4*>(qs + warp * RPW * QS);
    for (int d4 = 0; d4 < QS / 4; ++d4) {
      const float4 kd = k4[d4];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qd = q4[i * (QS / 4) + d4];
        sc[i] = fmaf(qd.x, kd.x, sc[i]);
        sc[i] = fmaf(qd.y, kd.y, sc[i]);
        sc[i] = fmaf(qd.z, kd.z, sc[i]);
        sc[i] = fmaf(qd.w, kd.w, sc[i]);
      }
    }

    // online softmax per row; a row past this tile's keys gets p = 0 and
    // a correction of 1 (rows past S*gp compute and are never written)
    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool valid = k0 + lane <= (w0 + i) / gp;
      const float s = valid ? sc[i] : NEG_INF;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[i], mx);
      p[i] = valid ? expf(s - m_new) : 0.f;
      float sum = p[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < HDC; ++c) acc[i][c] *= corr;
    }

    // P.V: each V row is read once for the warp's RPW rows
    const int jn = min(BK, pos_hi - k0 + 1);      // keys any row sees
    for (int j = 0; j < jn; ++j) {
      float vv[HDC];
#pragma unroll
      for (int c = 0; c < HDC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < hd ? vs[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pj = __shfl_sync(FULL, p[i], j);
#pragma unroll
        for (int c = 0; c < HDC; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = w0 + i;
    if (r >= rows) continue;
    const int s = r / gp, g = r - s * gp;
    float* o = out + q_base + s * q_stride_s + (long long)g * hd;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[((long long)b * kvp + h) * rows + r] = m[i] + logf(l[i]);
#pragma unroll
    for (int c = 0; c < HDC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) o[d] = acc[i][c] / den;
    }
  }
}

template <int HDC>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int kvp, int gp, int hd,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)ROWS * q_stride(hd) +
                                       (size_t)BK * k_stride(hd) +
                                       (size_t)BK * hd);
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel<HDC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S * gp + ROWS - 1) / ROWS, kvp, B);
  flash_f32_kernel<HDC><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, S,
      kvp, gp, hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int B, int S, int kvp, int gp, int hd,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (hd <= 16) return launch_tc<16>(q, k, v, out, l, B, S, kvp, gp, hd, s);
  if (hd <= 32) return launch_tc<32>(q, k, v, out, l, B, S, kvp, gp, hd, s);
  if (hd <= 64) return launch_tc<64>(q, k, v, out, l, B, S, kvp, gp, hd, s);
  if (hd <= 128) return launch_tc<128>(q, k, v, out, l, B, S, kvp, gp, hd, s);
  if (hd <= 256) return launch_tc<256>(q, k, v, out, l, B, S, kvp, gp, hd, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int S, int kvp, int gp, int hd,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (hd <= 32) return launch_f32<1>(q, k, v, out, l, B, S, kvp, gp, hd, s);
  if (hd <= 64) return launch_f32<2>(q, k, v, out, l, B, S, kvp, gp, hd, s);
  if (hd <= 128) return launch_f32<4>(q, k, v, out, l, B, S, kvp, gp, hd, s);
  if (hd <= 256) return launch_f32<8>(q, k, v, out, l, B, S, kvp, gp, hd, s);
  return (int)cudaErrorInvalidValue;
}
