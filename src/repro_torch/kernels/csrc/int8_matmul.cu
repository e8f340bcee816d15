// int8 x int8 -> int32 matrix product for Hopper (sm_90a), int8 tensor cores.
//
// Replaces the TPU kernel int8_matmul_pallas (src/repro/kernels/int8_matmul.py,
// body _int8_matmul_kernel): out[M,N] = x[M,K] . w[K,N], both row-major int8,
// accumulated exactly in int32 by mma.sync.m16n8k32.s32.s8.s8.s32.
//
// What bounds it on the serving path:
//   * decode, M = live rows <= 8: the K*N weight bytes (2*M ops per byte), so
//     the aim is every SM streaming weights with many 16-byte loads in flight;
//   * prefill, M = 256 (Qwen3 admission bucket) or 1024 (an RWKV-6 / Jamba
//     window of 8 x 128): tensor-core operations, with each weight byte read
//     once per 128 rows.
//
// The B operand.  Both int8 mma forms take B K-major (four K-consecutive
// bytes of one column in a register), and ldmatrix.trans exists only for
// 16-bit types, while w is N-major.  A thread therefore reads a word of four
// N-consecutive bytes from each of four K-consecutive rows and transposes the
// 4 x 4 byte block with __byte_perm (prmt), which gives the K-major words of
// four neighbouring columns.  Those four columns belong to one lane, not to
// four, so the four columns go to four different mma column tiles: the
// logical column `gid` of tile c is the physical column 4*gid + c (decode:
// 16*gid + ...).  A column permutation inside the block changes no sum; the
// epilogue maps the accumulators back, and each thread ends up holding runs
// of consecutive physical columns.
//
// Two tile configurations (the wrapper's pure-Python `plan` picks one by
// shape, with the split of K):
//   * decode_kernel (M <= 16): out^T = w^T . x^T, so the weights are the A
//     operand (16 columns x 32 K per mma) and the M <= 16 rows of x the
//     8-wide B operand (one or two m8 tiles: no 16-row padding work at M 8).
//     No shared memory on the weight path: each lane loads 16 bytes of N
//     from each of 8 K rows per 32-K step straight into registers (lanes of
//     one K row read 128 contiguous bytes), the next step's loads in flight
//     while this one is multiplied.  A block owns 128 columns and one K
//     split; its 8 warps take interleaved 32-K steps and meet through
//     shared-memory atomics.  K is split until the grid fills one wave of
//     two blocks per SM, so every SM streams weights.
//   * tile_kernel (M > 16): a BM x 128 output tile (BM 64 or 128), K in steps
//     of 64 bytes through a 4-stage cp.async ring in shared memory (x tile and
//     w tile, both with XOR-swizzled 16-byte chunks so the ldmatrix reads of x
//     and the 32-bit reads of w are free of bank conflicts), 8 warps of
//     (BM/2) x 32 each; A fragments by ldmatrix, B by four 32-bit loads and
//     the prmt transpose.  K is split over the grid only where the tiles
//     alone would leave SMs idle.
// The K splits of one output tile meet without a zeroed output (so no
// memset launch beside the kernel), through an atomic count per tile that
// the last split to finish resets: at decode each split adds its few rows of
// int32 sums into a zeroed accumulator for the tile and the last one writes
// the tile and zeroes the accumulator; the 64- and 128-row tiles are large,
// so each split leaves its partial tile in a workspace (int32 atomics on
// them were 2x slower at M 256) and the last one adds them up.  Integer sums
// are exact in any order.  Ragged M, K and N are masked (cp.async zero-fill,
// byte loads where rows are not 16-byte aligned), never padded in memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// r[i] holds bytes (row k+i, columns n..n+3), i = 0..3.  On return r[c]
// holds bytes (rows k..k+3, column n+c): the K-major word of column n+c.
__device__ __forceinline__ void transpose4x4(unsigned& r0, unsigned& r1,
                                             unsigned& r2, unsigned& r3) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const unsigned t1 = __byte_perm(r2, r3, 0x5140);  // r2.b0 r3.b0 r2.b1 r3.b1
  const unsigned t2 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const unsigned t3 = __byte_perm(r2, r3, 0x7362);
  r0 = __byte_perm(t0, t1, 0x5410);
  r1 = __byte_perm(t0, t1, 0x7632);
  r2 = __byte_perm(t2, t3, 0x5410);
  r3 = __byte_perm(t2, t3, 0x7632);
}

// Up to `avail` bytes from p (the rest zero), packed little-endian.
__device__ __forceinline__ uint4 bytes16(const int8_t* p, int avail) {
  unsigned b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < avail) b[j / 4] |= (unsigned)(uint8_t)p[j] << (8 * (j % 4));
  return make_uint4(b[0], b[1], b[2], b[3]);
}

__device__ __forceinline__ unsigned bytes4(const int8_t* p, int avail) {
  unsigned b = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < avail) b |= (unsigned)(uint8_t)p[j] << (8 * j);
  return b;
}

// 16 bytes of w row k from column n (zero past K or N).  VEC: N % 16 == 0
// and w 16-byte aligned, so a chunk lies wholly inside or outside N; the
// load streams past L1, as every weight byte is read once.
template <bool VEC>
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ w, int k,
                                          int n, int K, int N) {
  if (k >= K || n >= N) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* p = w + (long long)k * N + n;
  if (VEC) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
  }
  return bytes16(p, N - n);
}

// 4 bytes of x row m from column k (zero past M or K).
template <bool VEC>
__device__ __forceinline__ unsigned load_x4(const int8_t* __restrict__ x,
                                            int m, int k, int M, int K) {
  if (m >= M || k >= K) return 0u;
  const int8_t* p = x + (long long)m * K + k;
  if (VEC) return __ldg(reinterpret_cast<const unsigned*>(p));
  return bytes4(p, K - k);
}

// ---------------------------------------------------------------- decode
constexpr int D_WARPS = 8;       // warps per decode block
constexpr int D_DEPTH = 2;       // 32-K steps a warp keeps loading ahead
constexpr int D_BN = 128;        // output columns per block (16 per lane group)
constexpr int D_BK = 32;         // K bytes per mma step
constexpr int D_ROWS = 16;       // accumulator rows a column tile keeps
// Shared partial sums [16][D_BN] at row stride 164 with a skew of one word
// per 16 columns: the 32 lanes of one atomic hit 32 distinct banks.
constexpr int D_RED_STRIDE = 164;
__device__ __forceinline__ int red_index(int m, int c) {
  return m * D_RED_STRIDE + c + (c >> 4);
}

// The loads of one 32-K step of a warp: 8 rows x 16 bytes of w, and the
// B fragments of x.
template <int MT, bool VEC>
__device__ __forceinline__ void decode_load(const int8_t* __restrict__ x,
                                            const int8_t* __restrict__ w,
                                            int k0, int ncol, int gid, int tig,
                                            int M, int K, int N,
                                            uint4 (&raw)[8],
                                            unsigned (&xb)[MT][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      raw[4 * h + i] = load_w16<VEC>(w, k0 + 16 * h + 4 * tig + i, ncol, K, N);
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      xb[t][h] = load_x4<VEC>(x, 8 * t + gid, k0 + 16 * h + 4 * tig, M, K);
}

// The products of one step: transpose the weight words, then 8 x MT mma.
template <int MT>
__device__ __forceinline__ void decode_mma(const uint4 (&raw)[8],
                                           const unsigned (&xb)[MT][2],
                                           int (&acc)[MT][8][4]) {
  // col[h][j]: K-major word (K rows 16h + 4 tig .. +3) of column 16 gid + j
  unsigned col[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned* r = reinterpret_cast<const unsigned*>(&raw[4 * h]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned a = r[q], b = r[4 + q], c = r[8 + q], d = r[12 + q];
      transpose4x4(a, b, c, d);
      col[h][4 * q + 0] = a;
      col[h][4 * q + 1] = b;
      col[h][4 * q + 2] = c;
      col[h][4 * q + 3] = d;
    }
  }
  // mma j: A row gid <-> column 16 gid + 2j, row gid + 8 <-> 16 gid + 2j + 1
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < MT; ++t)
      mma_s8(acc[t][j], col[0][2 * j], col[0][2 * j + 1], col[1][2 * j],
             col[1][2 * j + 1], xb[t][0], xb[t][1]);
}

// Split-K fixup: true in every thread of the block that finished a tile's
// splits last, after this block left its partial sums (in the accumulator
// or the workspace); that block then writes the tile.  `count` is the
// tile's counter; the last block resets it.
__device__ __forceinline__ bool last_split(int* count, int splits) {
  __shared__ int last;
  __threadfence();                      // this block's sums, then count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count, 1) == splits - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();                      // the other splits' sums
  if (threadIdx.x == 0) *count = 0;
  return true;
}

// D_WARPS warps a block, each walking its own K steps of the block's split
// with DEPTH steps of loads in flight (a register ring; one step at MT 2,
// whose accumulators take the room); two blocks per SM for the register
// budget.  blockIdx.x is the 128-column tile, blockIdx.y the K split.
template <int MT, bool VEC>
__global__ void __launch_bounds__(D_WARPS * 32, 2)
decode_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              int* __restrict__ out, int* __restrict__ acc_ws,
              int* __restrict__ counts, int M, int K, int N, int per_split) {
  constexpr int THREADS = D_WARPS * 32, DEPTH = MT == 1 ? D_DEPTH : 1;
  __shared__ int red[MT * 8 * D_RED_STRIDE];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  for (int i = tid; i < MT * 8 * D_RED_STRIDE; i += THREADS) red[i] = 0;

  const int tile = blockIdx.x, n0 = tile * D_BN, ncol = n0 + 16 * gid;
  const int steps = (K + D_BK - 1) / D_BK, rows = min(M, MT * 8);
  const int s0 = blockIdx.y * per_split;
  const int s1 = min(steps, s0 + per_split);

  int acc[MT][8][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0;
  uint4 raw[DEPTH][8];
  unsigned xr[DEPTH][MT][2];
  const int first = s0 + warp;
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (first + d * D_WARPS < s1)
      decode_load<MT, VEC>(x, w, (first + d * D_WARPS) * D_BK, ncol, gid,
                           tig, M, K, N, raw[d], xr[d]);
  for (int s = first; s < s1; s += DEPTH * D_WARPS) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int sd = s + d * D_WARPS, sn = sd + DEPTH * D_WARPS;
      if (sd < s1) {
        decode_mma<MT>(raw[d], xr[d], acc);
        if (sn < s1)
          decode_load<MT, VEC>(x, w, sn * D_BK, ncol, gid, tig, M, K, N,
                               raw[d], xr[d]);
      }
    }
  }

  __syncthreads();                      // red zeroed
  if (first < s1) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = 8 * t + 2 * tig, c = 16 * gid + 2 * j;
        atomicAdd(&red[red_index(m, c)], acc[t][j][0]);
        atomicAdd(&red[red_index(m + 1, c)], acc[t][j][1]);
        atomicAdd(&red[red_index(m, c + 1)], acc[t][j][2]);
        atomicAdd(&red[red_index(m + 1, c + 1)], acc[t][j][3]);
      }
  }
  __syncthreads();

  if (gridDim.y == 1) {                 // the block holds the whole tile
    for (int i = tid; i < rows * D_BN; i += THREADS) {
      const int m = i / D_BN, c = i % D_BN, n = n0 + c;
      if (n < N) out[(long long)m * N + n] = red[red_index(m, c)];
    }
    return;
  }
  int* a = acc_ws + (long long)tile * D_ROWS * D_BN;
  for (int i = tid; i < rows * D_BN; i += THREADS)
    if (n0 + i % D_BN < N)
      atomicAdd(a + i, red[red_index(i / D_BN, i % D_BN)]);
  if (!last_split(&counts[tile], gridDim.y)) return;
  for (int i = tid; i < rows * D_BN; i += THREADS) {
    const int m = i / D_BN, n = n0 + i % D_BN;
    if (n >= N) continue;
    out[(long long)m * N + n] = __ldcg(a + i);
    a[i] = 0;
  }
}

// ---------------------------------------------------------------- tiles
constexpr int T_THREADS = 256;   // 8 warps: 2 along M x 4 along N
constexpr int T_BN = 128;
constexpr int T_BK = 64;         // K bytes per stage
constexpr int T_STAGES = 4;

// x tile [BM][64 B]: chunk c of row r at slot c ^ ((r >> 1) & 3)
__device__ __forceinline__ int xs_slot(int r, int c) {
  return r * 4 + (c ^ ((r >> 1) & 3));
}
// w tile [64][128 B]: chunk c of row r at slot c ^ (((r >> 2) & 3) << 1)
__device__ __forceinline__ int ws_slot(int r, int c) {
  return r * 8 + (c ^ (((r >> 2) & 3) << 1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

template <int BM, bool VEC>
__device__ __forceinline__ void tile_load(const int8_t* __restrict__ x,
                                          const int8_t* __restrict__ w,
                                          uint4* xs, uint4* ws, int m0, int n0,
                                          int k0, int M, int K, int N,
                                          int tid) {
#pragma unroll
  for (int i = tid; i < BM * 4; i += T_THREADS) {
    const int r = i / 4, c = i % 4, gm = m0 + r, gk = k0 + 16 * c;
    const bool ok = gm < M && gk < K;
    const int8_t* src = ok ? x + (long long)gm * K + gk : x;
    if (VEC) cp_async16(&xs[xs_slot(r, c)], src, ok);
    else xs[xs_slot(r, c)] = ok ? bytes16(src, K - gk) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = tid; i < T_BK * 8; i += T_THREADS) {
    const int r = i / 8, c = i % 8, gk = k0 + r, gn = n0 + 16 * c;
    const bool ok = gk < K && gn < N;
    const int8_t* src = ok ? w + (long long)gk * N + gn : w;
    if (VEC) cp_async16(&ws[ws_slot(r, c)], src, ok);
    else ws[ws_slot(r, c)] = ok ? bytes16(src, N - gn) : make_uint4(0, 0, 0, 0);
  }
}

template <int BM, bool VEC>
__global__ void __launch_bounds__(T_THREADS, 2)
tile_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            int* __restrict__ out, int* __restrict__ ws,
            int* __restrict__ counts, int M, int K, int N, int per_split) {
  constexpr int MI = BM / 32;              // m16 tiles per warp
  constexpr int XS = BM * 4, WS = T_BK * 8;  // 16-byte slots per stage
  extern __shared__ uint4 smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * T_BN;
  const int k_tiles = (K + T_BK - 1) / T_BK;
  const int kt0 = blockIdx.z * per_split;
  const int nk = min(k_tiles, kt0 + per_split) - kt0;

  int acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0;

#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < nk)
      tile_load<BM, VEC>(x, w, smem + s * (XS + WS), smem + s * (XS + WS) + XS,
                         m0, n0, (kt0 + s) * T_BK, M, K, N, tid);
    asm volatile("cp.async.commit_group;\n");
  }

  for (int t = 0; t < nk; ++t) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(T_STAGES - 2));
    __syncthreads();           // stage t landed; stage t - 1 free for reuse
    const int tn = t + T_STAGES - 1;
    if (tn < nk) {
      uint4* st = smem + (tn % T_STAGES) * (XS + WS);
      tile_load<BM, VEC>(x, w, st, st + XS, m0, n0, (kt0 + tn) * T_BK, M, K,
                         N, tid);
    }
    asm volatile("cp.async.commit_group;\n");

    const uint4* xs = smem + (t % T_STAGES) * (XS + WS);
    const unsigned* ws = reinterpret_cast<const unsigned*>(xs + XS);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {          // two 32-K halves of the stage
      unsigned a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r =
            wm * (BM / 2) + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = 2 * kk + (lane >> 4);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(a[i][0]), "=r"(a[i][1]), "=r"(a[i][2]), "=r"(a[i][3])
            : "r"(smem_u32(&xs[xs_slot(r, c)])));
      }
      // B: rows 32 kk + 16 h + 4 tig + i, bytes 32 wn + 4 gid .. +3
      unsigned b[2][4];
      const int c = 2 * wn + (gid >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 32 * kk + 16 * h + 4 * tig + i;
          b[h][i] = ws[ws_slot(r, c) * 4 + (gid & 3)];
        }
        transpose4x4(b[h][0], b[h][1], b[h][2], b[h][3]);
      }
      // tile c: logical column gid <-> physical column 32 wn + 4 gid + c
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          mma_s8(acc[i][cc], a[i][0], a[i][1], a[i][2], a[i][3], b[0][cc],
                 b[1][cc]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n");

  // accumulator (i, c, e): row gid (+8 for e >= 2), physical column
  // 32 wn + 8 tig + c (+4 for odd e): a thread holds 8 consecutive columns
  const int splits = gridDim.z;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int cl = 32 * wn + 8 * tig, col = n0 + cl;   // within tile, in out
  auto partial = [&](int sp, int rl) {   // split sp's [BM][T_BN] partial row
    return ws + (((long long)sp * gridDim.y * gridDim.x + tile) * BM + rl) *
                    T_BN + cl;
  };
  if (splits > 1) {                     // leave this split's partial tile
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int4* p = reinterpret_cast<int4*>(
            partial(blockIdx.z, wm * (BM / 2) + i * 16 + gid + 8 * half));
        p[0] = make_int4(acc[i][0][2 * half], acc[i][1][2 * half],
                         acc[i][2][2 * half], acc[i][3][2 * half]);
        p[1] = make_int4(acc[i][0][2 * half + 1], acc[i][1][2 * half + 1],
                         acc[i][2][2 * half + 1], acc[i][3][2 * half + 1]);
      }
    if (!last_split(&counts[tile], splits)) return;
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = wm * (BM / 2) + i * 16 + gid + 8 * half, row = m0 + rl;
      if (row >= M) continue;
      int v[8];
      if (splits == 1) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          v[cc] = acc[i][cc][2 * half];
          v[4 + cc] = acc[i][cc][2 * half + 1];
        }
      } else {                          // every split's partial, own too
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0;
#pragma unroll 4
        for (int sp = 0; sp < splits; ++sp) {
          const int4* p = reinterpret_cast<const int4*>(partial(sp, rl));
          const int4 a = __ldcg(p), b = __ldcg(p + 1);
          v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
          v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
        }
      }
      int* o = out + (long long)row * N + col;
      if (VEC && col + 8 <= N) {
        reinterpret_cast<int4*>(o)[0] = make_int4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<int4*>(o)[1] = make_int4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < N) o[e] = v[e];
      }
    }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > 0) {               // beside the static fixup flag
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// bm: 16 runs decode_kernel (M <= 16), 64 or 128 tile_kernel with that
// many rows a tile; tiles are 128 columns wide.  K is cut into splits of
// `per` K steps (32 bytes for the decode kernel, 64 for the tiles).  With
// more than one split, counts holds zeroed int32 [tiles] and scratch, at
// decode, zeroed int32 accumulators [tiles][16][128] (both left zero
// again), and for the tiles room for the partials, int32
// [splits][tiles][bm][128].  Returns a cudaError_t.
extern "C" int int8_matmul_s8s32(const void* x, const void* w, void* out,
                                 void* scratch, void* counts, int M, int K,
                                 int N, int bm, int per, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  int* op = (int*)out;
  int* ap = (int*)scratch;
  int* cp = (int*)counts;
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 == 0;
  if (per < 1) return (int)cudaErrorInvalidValue;
  if (bm == 16) {
    if (M > 16) return (int)cudaErrorInvalidValue;
    const int steps = (K + D_BK - 1) / D_BK;
    const dim3 grid((N + D_BN - 1) / D_BN, (steps + per - 1) / per);
    const int t = D_WARPS * 32;
    if (M <= 8)
      return vec ? launch(decode_kernel<1, true>, grid, t, 0, s, xp, wp, op,
                          ap, cp, M, K, N, per)
                 : launch(decode_kernel<1, false>, grid, t, 0, s, xp, wp, op,
                          ap, cp, M, K, N, per);
    return vec ? launch(decode_kernel<2, true>, grid, t, 0, s, xp, wp, op, ap,
                        cp, M, K, N, per)
               : launch(decode_kernel<2, false>, grid, t, 0, s, xp, wp, op, ap,
                        cp, M, K, N, per);
  }
  if (bm != 64 && bm != 128) return (int)cudaErrorInvalidValue;
  const int k_tiles = (K + T_BK - 1) / T_BK;
  dim3 grid((N + T_BN - 1) / T_BN, (M + bm - 1) / bm,
            (k_tiles + per - 1) / per);
  const size_t smem = (size_t)T_STAGES * (bm * 64 + T_BK * T_BN);
  if (bm == 64)
    return vec ? launch(tile_kernel<64, true>, grid, T_THREADS, smem, s, xp, wp,
                        op, ap, cp, M, K, N, per)
               : launch(tile_kernel<64, false>, grid, T_THREADS, smem, s, xp,
                        wp, op, ap, cp, M, K, N, per);
  return vec ? launch(tile_kernel<128, true>, grid, T_THREADS, smem, s, xp, wp,
                      op, ap, cp, M, K, N, per)
             : launch(tile_kernel<128, false>, grid, T_THREADS, smem, s, xp, wp,
                      op, ap, cp, M, K, N, per);
}
