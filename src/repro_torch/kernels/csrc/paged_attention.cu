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
// Online softmax in f32, q scaled by 1/sqrt(hd), out = acc / max(l, 1e-30),
// and a sequence of length 0 returns exactly 0.
//
// What bounds it: every K and V byte of a live block is read once and used
// for gp query rows, so a step reads sum_b ceil(len_b/P)*P*KVp*hd*2 bytes for
// K and again for V against ~4*gp flops per pair of bytes: it is bound by
// device-memory bytes.  Design: one block per (sequence, kv head), so the gp
// query rows of a kv head share each K/V tile staged once in shared memory.
// The block walks only the ceil(len/P) live table entries and loads each
// entry itself; the TPU kernel instead clamps dead entries to row 0 and
// predicates its body off.  Dead entries and the trash row are never read.
// Scores and the P.V sum run as f32 FMAs on CUDA cores.  With B*KVp blocks a
// small batch fills few SMs; splitting a long sequence over blocks is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // 4 warps
constexpr int MAX_HD = 256;    // each thread owns up to two head-dim lanes

template <int G>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       const int* __restrict__ block_table,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out,
                       int kvp, int hd, int page, int mb) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [G, hd]   q / sqrt(hd)
  float* ks = qs + G * hd;             // [P, hd]   K tile
  float* vs = ks + page * hd;          // [P, hd]   V tile
  float* ss = vs + page * hd;          // [G, P]    scores, then probabilities
  float* m_s = ss + G * page;          // [G]       running max
  float* l_s = m_s + G;                // [G]       running denominator
  float* c_s = l_s + G;                // [G]       this block's rescale factor

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];
  const int nblk = min((len + page - 1) / page, mb);
  const float rsq = sqrtf((float)hd);

  const long long q_off = ((long long)b * kvp + h) * G * hd;
  for (int i = tid; i < G * hd; i += THREADS)
    qs[i] = __bfloat162float(q[q_off + i]) / rsq;
  if (tid < G) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    // live entries are >= 0; clamp like the reference for a malformed table
    const long long row = max(block_table[(long long)b * mb + j], 0);
    __syncthreads();                   // previous tile fully consumed
    for (int i = tid; i < page * hd; i += THREADS) {
      const int p = i / hd, d = i - p * hd;
      const long long off = ((row * page + p) * kvp + h) * hd + d;
      ks[i] = __bfloat162float(k_pool[off]);
      vs[i] = __bfloat162float(v_pool[off]);
    }
    __syncthreads();
    for (int p = warp; p < page; p += THREADS / 32) {
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float kd = ks[p * hd + d];
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = fmaf(qs[g * hd + d], kd, part[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      }
      if (lane == 0) {
        const bool valid = j * page + p < len;
#pragma unroll
        for (int g = 0; g < G; ++g) ss[g * page + p] = valid ? part[g] : -1e30f;
      }
    }
    __syncthreads();
    if (tid < G) {
      const int g = tid;
      float mx = m_s[g];
      for (int p = 0; p < page; ++p) mx = fmaxf(mx, ss[g * page + p]);
      float sum = 0.f;
      for (int p = 0; p < page; ++p) {
        const float e = (j * page + p < len) ? expf(ss[g * page + p] - mx) : 0.f;
        ss[g * page + p] = e;
        sum += e;
      }
      const float corr = expf(m_s[g] - mx);
      c_s[g] = corr;
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      const int d = tid + dd * THREADS;
      if (d < hd) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float a = acc[g][dd] * c_s[g];
          for (int p = 0; p < page; ++p) a = fmaf(ss[g * page + p], vs[p * hd + d], a);
          acc[g][dd] = a;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int dd = 0; dd < 2; ++dd) {
    const int d = tid + dd * THREADS;
    if (d < hd) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        out[q_off + (long long)g * hd + d] =
            __float2bfloat16(acc[g][dd] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <int G>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* lengths, void* out, int B, int kvp,
           int hd, int page, int mb, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (G * hd + 2 * page * hd + G * page + 3 * G);
  dim3 grid(B, kvp);
  paged_attention_kernel<G><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, table, lengths, (__nv_bfloat16*)out, kvp,
      hd, page, mb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* block_table,
                                    const void* lengths, void* out, int B,
                                    int kvp, int gp, int hd, int page, int mb,
                                    void* stream) {
  if (hd > MAX_HD) return (int)cudaErrorInvalidValue;
  const int* t = (const int*)block_table;
  const int* l = (const int*)lengths;
  cudaStream_t s = (cudaStream_t)stream;
  switch (gp) {
#define REPRO_GP(G) \
  case G: return launch<G>(q, k_pool, v_pool, t, l, out, B, kvp, hd, page, mb, s);
    REPRO_GP(1) REPRO_GP(2) REPRO_GP(3) REPRO_GP(4) REPRO_GP(5) REPRO_GP(6)
    REPRO_GP(7) REPRO_GP(8) REPRO_GP(16)
#undef REPRO_GP
    default: return (int)cudaErrorInvalidValue;
  }
}

