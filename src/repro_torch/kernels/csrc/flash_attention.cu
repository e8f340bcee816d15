// Causal flash attention (prefill) for Hopper (sm_90a), grouped-query layout.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py, body _flash_kernel).  Contract:
//   q    [B, S, KVp, gp, hd]   -- gp query heads share each kv head
//   k, v [B, S, KVp, hd]
//   out  [B, S, KVp, gp, hd]
// bf16 or f32 in (q, k, v and out alike), f32 inside: scores q.k / sqrt(hd),
// query s sees keys 0..s, online softmax, out = acc / max(l, 1e-30).
//
// What bounds it: at the engine's admission round (S = 32) it reads and
// writes a few MB and is bound by bytes; at a long prefill it does
// 4*S^2/2*hd flops per query head, which on f32 CUDA cores bounds it by
// operations.  Design: the S*gp query rows of one (batch, kv head) are cut
// into blocks of 64 rows (8 warps x 8 rows); a block stages its rows' q once
// and walks the K/V tiles of 32 keys at or below its last row's position,
// so tiles wholly above the diagonal are skipped as on the TPU, and the gp
// query heads of the kv head share each K/V tile staged once in shared
// memory (no repeated KV heads).  Lane j of a warp scores key j of the tile
// for the warp's 8 rows with 16-byte shared loads; the softmax statistics
// are warp reductions, kept in registers with the rows' accumulators (lane
// owns dims lane + 32c), and each V row is read once for all 8 rows.
// Ragged S is masked: keys past S are zero and past every row's position,
// rows past S*gp are never written.  wgmma tiles and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;            // 8 warps
constexpr int RPW = 8;                  // query rows per warp
constexpr int ROWS = THREADS / 32 * RPW;  // 64 query rows per block
constexpr int BK = 32;                  // keys per tile, one per lane
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared-memory row strides: q and K rows padded to whole float4s (zeros
// past hd), K rows by 4 more so the lanes' 16-byte loads of 8 consecutive
// rows fall in distinct banks.
__host__ __device__ constexpr int q_stride(int hd) { return (hd + 3) / 4 * 4; }
__host__ __device__ constexpr int k_stride(int hd) { return q_stride(hd) + 4; }

template <typename T, int HDC>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int seq, int kvp,
             int gp, int hd) {
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
      x = to_f(q[q_base + s * q_stride_s + (long long)g * hd + d]) / rsq;
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
        kx = to_f(k[off]);
        vs[j * hd + d] = to_f(v[off]);
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
    T* o = out + q_base + s * q_stride_s + (long long)g * hd;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < HDC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) store(o + d, acc[i][c] / den);
    }
  }
}

template <typename T, int HDC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int kvp, int gp, int hd, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)ROWS * q_stride(hd) +
                                       (size_t)BK * k_stride(hd) +
                                       (size_t)BK * hd);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HDC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S * gp + ROWS - 1) / ROWS, kvp, B);
  flash_kernel<T, HDC><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, kvp, gp, hd);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int kvp, int gp, int hd, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 32) return launch<T, 1>(q, k, v, out, B, S, kvp, gp, hd, s);
  if (hd <= 64) return launch<T, 2>(q, k, v, out, B, S, kvp, gp, hd, s);
  if (hd <= 128) return launch<T, 4>(q, k, v, out, B, S, kvp, gp, hd, s);
  if (hd <= 256) return launch<T, 8>(q, k, v, out, B, S, kvp, gp, hd, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int kvp, int gp, int hd, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, B, S, kvp, gp, hd, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int kvp, int gp, int hd, void* stream) {
  return dispatch<float>(q, k, v, out, B, S, kvp, gp, hd, stream);
}
