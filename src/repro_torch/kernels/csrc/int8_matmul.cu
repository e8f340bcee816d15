// int8 x int8 -> int32 matrix product for Hopper (sm_90a), CUDA cores.
//
// Replaces the TPU kernel int8_matmul_pallas (src/repro/kernels/int8_matmul.py,
// body _int8_matmul_kernel): out[M,N] = x[M,K] . w[K,N], both row-major int8,
// accumulated exactly in int32.
//
// What bounds it: on the serving path M is the number of live decode slots
// (<= 8), so the product reads K*N weight bytes for 2*M*K*N operations -- it is
// bound by device-memory bytes, not by operations.  The design therefore aims
// at spreading the weight read over every SM: a block computes a 32 x 64 output
// tile with __dp4a (four int8 products per instruction), and the K loop is split
// across gridDim.z when the output tiles alone would leave SMs idle.  Split
// partial sums meet through int32 atomicAdd: integer addition is associative,
// so the result is exact and the same in every run.  Ragged edges are masked
// in the loads and the store, never padded.  Tensor-core (mma/wgmma) tiles and
// TMA staging are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 64;        // K bytes per shared-memory stage
constexpr int KQ = BK / 4;    // packed 4-byte words per stage row
constexpr int THREADS = 256;  // 16 x 16 threads, each 2 rows x 4 columns

__device__ __forceinline__ int pack4(const int8_t* p, long long stride, int avail) {
  // Four K-consecutive int8 values (stride apart in memory) packed into one
  // word for __dp4a; values past the ragged K edge read as zero.
  unsigned v = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (r < avail) v |= (unsigned)(unsigned char)p[r * stride] << (8 * r);
  return (int)v;
}

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int* __restrict__ out, int M, int K, int N,
                   int k_tiles_per_split, int atomic) {
  __shared__ int xs[BM][KQ + 1];   // x tile, packed along K
  __shared__ int ws[BN][KQ + 1];   // w tile transposed to [n][K/4]; +1 pads banks
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = blockIdx.z * k_tiles_per_split;
  const int kt1 = min(k_tiles, kt0 + k_tiles_per_split);

  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < (BM * KQ) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / KQ, kq = idx % KQ;
      const int gm = m0 + r, gk = k0 + kq * 4;
      xs[r][kq] = (gm < M && gk < K)
                      ? pack4(x + (long long)gm * K + gk, 1, K - gk) : 0;
    }
#pragma unroll
    for (int i = 0; i < (BN * KQ) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int c = idx % BN, kq = idx / BN;   // neighbouring threads, neighbouring n
      const int gn = n0 + c, gk = k0 + kq * 4;
      ws[c][kq] = (gn < N && gk < K)
                      ? pack4(w + (long long)gk * N + gn, N, K - gk) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      const int a0 = xs[ty][kq], a1 = xs[ty + 16][kq];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = ws[tx + 16 * j][kq];
        acc[0][j] = __dp4a(a0, b, acc[0][j]);
        acc[1][j] = __dp4a(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        int* o = out + (long long)gm * N + gn;
        if (atomic) atomicAdd(o, acc[i][j]);
        else *o = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" int int8_matmul_s8s32(const void* x, const void* w, void* out,
                                 int M, int K, int N, int splits,
                                 void* stream) {
  // out must hold zeros when splits > 1 (the splits add into it).
  const int k_tiles = (K + BK - 1) / BK;
  const int per_split = (k_tiles + splits - 1) / splits;
  const int grid_z = (k_tiles + per_split - 1) / per_split;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, grid_z);
  int8_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (int*)out, M, K, N, per_split,
      grid_z > 1);
  return (int)cudaGetLastError();
}
