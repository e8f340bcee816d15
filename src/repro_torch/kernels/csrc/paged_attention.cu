// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against a KV cache that lives in fixed-size blocks of a shared pool.
//
// Replaces the TPU kernel paged_attention_pallas
// (src/repro/kernels/paged_attention.py, body _paged_kernel).  Same contract:
//   q       [B, KVp, gp, hd] bf16     -- gp query heads share each kv head
//   pools   [rows, P, KVp, hd] bf16   -- row rows-1 is the trash row
//   table   [B, MB] int32             -- pool row of each block, -1 = dead
//   lengths [B] int32                 -- tokens written per sequence
//   out     [B, KVp, gp, hd] bf16
// Online softmax in f32, scores q.k / sqrt(hd), out = acc / max(l, 1e-30),
// and a sequence of length 0 returns exactly 0.
//
// What bounds it: every K and V byte of a live block is read once and used
// for gp query rows, ~4*gp flops per pair of bf16 bytes (~5 flops a byte at
// gp 5): it is bound by device-memory bytes.  So what matters is how many
// blocks stream and how many bytes each keeps in flight, and that the
// instructions per token stay few enough to keep up with the bytes.  A
// first CUDA-core version of this design, each lane holding 8 dims of a
// K/V row and the gp scores summed over 16 lanes by shuffles, ran at a
// quarter of the HBM rate at 8 sequences of 4096 tokens on the H100; on
// the tensor cores a token's scores and sums are a few mma instructions.
//
// Design (flash-decoding on mma.sync):
// * Grid (B, KVp, splits).  Split z owns table columns [z*cols, (z+1)*cols);
//   splits and cols come from the wrapper's plan(B, KVp, MB, SMs), never
//   from lengths, so a decode step's grid has a fixed shape.  A split that
//   lies wholly past lengths[b] returns at once and reads nothing.
// * A block (4 warps) streams its split's tokens as 64-token K/V tiles
//   through a cp.async ring in shared memory (3 stages, 2 at hd 256): each
//   16-byte chunk of a token's head row is one copy, its pool row found in
//   the block table, so two tiles are in flight while one is used.  Rows
//   are padded to a power-of-two head dim and their chunks XOR-swizzled, so
//   every ldmatrix is free of bank conflicts.
// * The gp query rows of the kv head, padded to the 16 rows of an mma tile,
//   stay in registers as A fragments and share every K/V row; each warp
//   takes 16 tokens of a tile: S = Q.K^T by mma.sync.m16n8k16 (bf16 in, f32
//   sums), the online softmax on the accumulators (a quad shuffle for the
//   row max, exp2 with log2(e)/sqrt(hd) folded into the FFMA that feeds
//   it), and O += P.V with P from the S accumulators as hi + lo bf16 A
//   fragments (16 bits of P, as the flash kernel does) and V by
//   ldmatrix.trans.
// * The warps' (m, l, O) meet in shared memory in warp order.  One launch
//   per call: with one live split the block writes out directly; otherwise
//   each live split writes its partial (m, l, acc) to scratch, and the last
//   of them to arrive (a per-(b, head) counter after __threadfence())
//   combines the partials in split order into out and sets the counter back
//   to 0.  No atomics touch values, so two launches on the same inputs give
//   bit-identical outputs.
// Dead entries and the trash row are never read: a block reads a table
// entry only for a token below lengths[b].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16;           // query rows of the mma tile (gp <= 16)
constexpr int TK = 16 * WARPS;     // tokens per K/V tile, 16 per warp
constexpr int MAX_HD = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float EMPTY = -1e30f;    // running max of a set with no token
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int stages(int hdp) {
  return hdp <= 128 ? 3 : 2;
}

// floats of the small arrays: per-warp (m, l), the block's (m, l), the
// last-arrival flag (rounded to 16 bytes)
__host__ __device__ constexpr int small_floats() {
  return (2 * WARPS * ROWS + 2 * ROWS + 1 + 3) / 4 * 4;
}

// dynamic shared memory; paged_attention.py smem_bytes mirrors it
__host__ __device__ constexpr int smem_bytes(int hdp) {
  return ROWS * hdp * 2 + 4 * small_floats() + stages(hdp) * 2 * TK * hdp * 2;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte slot of chunk c of row r in a [rows][HDP] bf16 tile (the flash
// kernel's swizzle): the 8 rows of one ldmatrix matrix land in 8 distinct
// 16-byte bank groups
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
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       const int* __restrict__ block_table,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partial, int* __restrict__ counts,
                       int kvp, int gp, int hd, int page, int mb, int cols,
                       int splits, float scale_log2, int vec) {
  constexpr int CH = HDP / 8;        // 16-byte chunks per row
  constexpr int KS = HDP / 16;       // k16 steps of Q.K^T
  constexpr int NT = HDP / 8;        // n8 tiles of O
  constexpr bool Q_IN_REGS = HDP <= 128;
  constexpr int STAGES = stages(HDP);
  extern __shared__ uint4 smem[];
  uint4* qs = smem;                                   // [ROWS][CH]
  float* wm = reinterpret_cast<float*>(qs + ROWS * CH);   // [WARPS][ROWS]
  float* wl = wm + WARPS * ROWS;                      // [WARPS][ROWS]
  float* bm = wl + WARPS * ROWS;                      // [ROWS]
  float* bl = bm + ROWS;                              // [ROWS]
  int* last = reinterpret_cast<int*>(bl + ROWS);
  uint4* ks = reinterpret_cast<uint4*>(wm + small_floats());  // [STAGES][TK]
  uint4* vs = ks + STAGES * TK * CH;                  // [STAGES][TK][CH]
  float* wacc = reinterpret_cast<float*>(ks);         // [WARPS][gp][hd], after

  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int pair = b * kvp + h;
  const long long q_off = (long long)pair * gp * hd;
  const int len = min(lengths[b], mb * page);
  const int span = cols * page;                       // tokens per split
  const int live = (len + span - 1) / span;           // splits with tokens
  if (len <= 0) {                    // nothing to attend to: exactly 0
    if (z == 0)
      for (int e = tid; e < gp * hd; e += THREADS)
        out[q_off + e] = __float2bfloat16(0.f);
    return;
  }
  if (z >= live) return;
  const int t0 = z * span, t1 = min(t0 + span, len);
  const int ntiles = (t1 - t0 + TK - 1) / TK;
  const bool vc = vec != 0;
  const int* trow = block_table + (long long)b * mb;
  const long long pos_stride = (long long)kvp * hd;   // one token of a page

  for (int i = tid; i < ROWS * CH; i += THREADS) {    // q rides with tile 0
    const int g = i / CH, c = i % CH;
    stage16(&qs[slot<HDP>(g, c)], q + q_off + (long long)min(g, gp - 1) * hd,
            c, hd, g < gp, vc, q);
  }
  // a tile's copies: every table entry first, then every cp.async, so the
  // entries' loads overlap instead of each holding up its copy
  auto stage_kv = [&](int t, int buf) {
    constexpr int PER = TK * CH / THREADS;            // chunks a thread
    uint4* kb = ks + buf * TK * CH;
    uint4* vb = vs + buf * TK * CH;
    int slot_row[PER];                                // pool row * P + offset
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int tok = t0 + t * TK + (tid + u * THREADS) / CH;
      slot_row[u] = tok < t1
          ? max(__ldg(trow + tok / page), 0) * page + tok % page : -1;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * THREADS, j = i / CH, c = i % CH;
      const bool ok = slot_row[u] >= 0;
      const long long off =
          ok ? slot_row[u] * pos_stride + (long long)h * hd : 0;
      stage16(&kb[slot<HDP>(j, c)], k_pool + off, c, hd, ok, vc, k_pool);
      stage16(&vb[slot<HDP>(j, c)], v_pool + off, c, hd, ok, vc, v_pool);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) stage_kv(st, st);
    asm volatile("cp.async.commit_group;\n");
  }

  float m_a = EMPTY, m_b = EMPTY, l_a = 0.f, l_b = 0.f;
  float o[NT][4];
#pragma unroll
  for (int d = 0; d < NT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  unsigned qf[Q_IN_REGS ? KS : 1][4];
  const int qrow = (lane & 7) + ((lane >> 3) & 1) * 8;

  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2));
    __syncthreads();      // tile t landed; every warp is done with t - 1
    if (t + STAGES - 1 < ntiles)
      stage_kv(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    asm volatile("cp.async.commit_group;\n");
    if (Q_IN_REGS && t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[Q_IN_REGS ? kk : 0],
                &qs[slot<HDP>(qrow, 2 * kk + (lane >> 4))]);
    }
    const int w0 = t0 + t * TK + 16 * warp;           // the warp's first token
    if (w0 >= t1) continue;                           // nothing live here
    const uint4* kb = ks + (t % STAGES) * TK * CH;
    const uint4* vb = vs + (t % STAGES) * TK * CH;
    // S = Q.K^T for the warp's 16 tokens: n8 tile j holds tokens 8j..8j+7
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const int key = 16 * warp + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4];
      if (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[Q_IN_REGS ? kk : 0][e];
      } else {
        ldsm_x4(a, &qs[slot<HDP>(qrow, 2 * kk + (lane >> 4))]);
      }
      unsigned bk[4];
      ldsm_x4(bk, &kb[slot<HDP>(key, 2 * kk + ((lane >> 3) & 1))]);
      mma_bf16(s[0], a, bk[0], bk[1]);
      mma_bf16(s[1], a, bk[2], bk[3]);
    }
    // online softmax on the raw f32 scores, rows gid (a) and gid + 8 (b);
    // p = 2^(s c - m c), c = log2(e) / sqrt(hd), in one FFMA; a token past
    // the split's end gets p = 0 (its m may still be EMPTY)
    bool ok[2][2];
    float mx_a = EMPTY, mx_b = EMPTY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[j][e] = w0 + 8 * j + 2 * tig + e < t1;
        if (ok[j][e]) {
          mx_a = fmaxf(mx_a, s[j][e]);
          mx_b = fmaxf(mx_b, s[j][2 + e]);
        }
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
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = ok[j][e] ? ex2(fmaf(s[j][e], scale_log2, off_a)) : 0.f;
        s[j][2 + e] =
            ok[j][e] ? ex2(fmaf(s[j][2 + e], scale_log2, off_b)) : 0.f;
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
    // O += P.V for the 16 tokens, P as hi + lo bf16 A fragments
    unsigned hi[4], lo[4];
    split_pair(s[0][0], s[0][1], hi[0], lo[0]);
    split_pair(s[0][2], s[0][3], hi[1], lo[1]);
    split_pair(s[1][0], s[1][1], hi[2], lo[2]);
    split_pair(s[1][2], s[1][3], hi[3], lo[3]);
    const int vkey = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int d = 0; d < NT; d += 2) {
      unsigned bv[4];
      ldsm_x4_t(bv, &vb[slot<HDP>(vkey, d + (lane >> 4))]);
      mma_bf16(o[d], hi, bv[0], bv[1]);
      mma_bf16(o[d], lo, bv[0], bv[1]);
      mma_bf16(o[d + 1], hi, bv[2], bv[3]);
      mma_bf16(o[d + 1], lo, bv[2], bv[3]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n");
  __syncthreads();                   // the ring is free for the warps' O

  // each lane summed only its own columns of p: the quad holds a row's l
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(FULL, l_a, o_);
    l_b += __shfl_xor_sync(FULL, l_b, o_);
  }
  const int ra = gid, rb = gid + 8;
  if (tig == 0) {
    wm[warp * ROWS + ra] = m_a;
    wl[warp * ROWS + ra] = l_a;
    wm[warp * ROWS + rb] = m_b;
    wl[warp * ROWS + rb] = l_b;
  }
#pragma unroll
  for (int d = 0; d < NT; ++d) {
    const int col = 8 * d + 2 * tig;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= hd) continue;
      if (ra < gp) wacc[(warp * gp + ra) * hd + col + e] = o[d][e];
      if (rb < gp) wacc[(warp * gp + rb) * hd + col + e] = o[d][2 + e];
    }
  }
  __syncthreads();
  // merge the warps: weights per (warp, row), then every (row, dim)
  if (tid < gp) {
    float mx = EMPTY;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * ROWS + tid]);
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float a = ex2((wm[w * ROWS + tid] - mx) * scale_log2);
      wm[w * ROWS + tid] = a;
      sum = fmaf(wl[w * ROWS + tid], a, sum);
    }
    bm[tid] = mx;
    bl[tid] = sum;
  }
  __syncthreads();
  const int stride = gp * (hd + 2);                   // one split's partial
  float* mine = partial + ((long long)pair * splits + z) * stride;
  for (int e = tid; e < gp * hd; e += THREADS) {
    const int g = e / hd;
    float a = 0.f;
    for (int w = 0; w < WARPS; ++w)
      a = fmaf(wacc[w * gp * hd + e], wm[w * ROWS + g], a);
    if (live == 1)
      out[q_off + e] = __float2bfloat16(a / fmaxf(bl[g], 1e-30f));
    else
      mine[2 * gp + e] = a;
  }
  if (live == 1) return;
  if (tid < gp) {
    mine[tid] = bm[tid];
    mine[gp + tid] = bl[tid];
  }
  __threadfence();                   // the partial is visible before the count
  __syncthreads();
  if (tid == 0) {
    const int seen = atomicAdd(counts + pair, 1);
    *last = seen == live - 1;
    if (*last) counts[pair] = 0;     // ready for the next launch
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // the last split combines every live split's partial in split order, an
  // online rescale per split, each element's (m, l, acc) of 8 splits
  // loaded at once (one L2 round trip where there are 8 splits or fewer)
  const float* all = partial + (long long)pair * splits * stride;
  for (int e = tid; e < gp * hd; e += THREADS) {
    const int g = e / hd;
    float mx = EMPTY, sum = 0.f, a = 0.f;
    for (int i0 = 0; i0 < live; i0 += 8) {
      float pm[8], pl[8], pa[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* p = all + (i0 + u) * stride;
        const bool in = i0 + u < live;
        pm[u] = in ? __ldcg(p + g) : EMPTY;
        pl[u] = in ? __ldcg(p + gp + g) : 0.f;
        pa[u] = in ? __ldcg(p + 2 * gp + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + u >= live) break;
        const float mn = fmaxf(mx, pm[u]);
        const float corr = ex2((mx - mn) * scale_log2);
        const float wgt = ex2((pm[u] - mn) * scale_log2);
        sum = fmaf(pl[u], wgt, sum * corr);
        a = fmaf(pa[u], wgt, a * corr);
        mx = mn;
      }
    }
    out[q_off + e] = __float2bfloat16(a / fmaxf(sum, 1e-30f));
  }
}

template <int HDP>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* lengths, void* out, float* partial,
           int* counts, int B, int kvp, int gp, int hd, int page, int mb,
           int cols, int splits, cudaStream_t stream) {
  const int smem = smem_bytes(HDP);
  cudaError_t e = cudaFuncSetAttribute(
      paged_attention_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = hd % 8 == 0 &&
      (((size_t)q | (size_t)k_pool | (size_t)v_pool) % 16) == 0;
  const float scale_log2 = LOG2E / sqrtf((float)hd);
  dim3 grid(B, kvp, splits);
  paged_attention_kernel<HDP><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, table, lengths, (__nv_bfloat16*)out,
      partial, counts, kvp, gp, hd, page, mb, cols, splits, scale_log2, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// partial: f32 scratch of B*KVp*splits*gp*(hd+2) (unused when splits == 1);
// counts: B*KVp int32, zero before the launch and zero after it.
extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* block_table,
                                    const void* lengths, void* out,
                                    void* partial, void* counts, int B,
                                    int kvp, int gp, int hd, int page, int mb,
                                    int cols, int splits, void* stream) {
  if (hd > MAX_HD || hd < 1 || gp < 1 || gp > ROWS || splits < 1 ||
      cols < 1 || page < 1 ||
      (splits > 1 && (partial == nullptr || counts == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* t = (const int*)block_table;
  const int* l = (const int*)lengths;
  float* p = (float*)partial;
  int* c = (int*)counts;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_HDP(H)                                                     \
  if (hd <= H)                                                           \
    return launch<H>(q, k_pool, v_pool, t, l, out, p, c, B, kvp, gp, hd, \
                     page, mb, cols, splits, s);
  REPRO_HDP(16) REPRO_HDP(32) REPRO_HDP(64) REPRO_HDP(128) REPRO_HDP(256)
#undef REPRO_HDP
  return (int)cudaErrorInvalidValue;
}
