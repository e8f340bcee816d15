// Row-wise absmax int8 quantization for Hopper (sm_90a), standalone and
// fused into the int8 KV cache write.
//
// Replaces the TPU kernel rowwise_quant_pallas (src/repro/kernels/quant.py,
// body _quant_kernel).  Per row of K elements (bf16 or f32):
//   amax  = max_k |x[k]|                      (in f32)
//   scale = max(amax, 1e-8) * inv_qmax        (inv_qmax = f32(1/127))
//   q[k]  = clamp(rint(x[k] / scale), -127, 127)   int8
// The scale is the product with the f32 reciprocal, not a division by 127:
// that is what XLA's jit makes of the reference's `/ 127.0`, and the codes
// match only that way.  x / scale is a true IEEE division (no fast math)
// and rint rounds half to even, as jnp.round does.
//
// Rows: each of the `tensors` sources (the row-wise quant: x; the KV
// write: k and v) is [B, S, H, K] contiguous, one row per (b, i, h).  Row
// (b, i, h) goes to codes q + b*qs_b + slot*qs_t + h*qs_h (K int8, unit
// stride) and its scale to scale + b*ss_b + slot*ss_t + h*ss_h, where
//   * slot_ptr given (decode, S = 1): slot = *slot_ptr;
//   * else (prefill into a cache of T slots): slot = i % T, and the rows
//     with i < S - T are not written (the ring-aligned trailing window).
// The row-wise quant is the case B = M, S = H = T = 1, qs_b = K, ss_b = 1.
//
// What bounds it: each element is read once (2 or 4 bytes) and written once
// (1 byte), a handful of operations each, so it is bound by device-memory
// bytes; at the KV cache's decode shape (64 rows of 128 per tensor) it is
// bound by the launch and one round trip to memory.  Design: g lanes a row
// (g a power of two), each lane loading R vectors of VB bytes (16, or 8
// where the rows' lanes still fit one wave of the card: a 128-wide bf16
// row is then 32 lanes of 8 bytes, and each lane's chain of true divisions
// is half as long) and keeping them in registers, so the row is read once;
// the absmax by xor shuffles within the g lanes; the codes of a vector
// packed into one store.  The standalone quant addresses its rows
// directly; the KV write maps each row to its slot.  A row whose bytes are
// not a multiple of 8, or a pointer or stride off its boundary, takes the
// scalar path (one warp a row, the row read twice).  k and v are one
// launch (blockIdx.y).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Rows {
  const void* src[2];
  signed char* q[2];
  float* scale[2];
  const int* slot_ptr;     // decode: the slot of the one token; else null
  long long qs_b, qs_t, qs_h, ss_b, ss_t, ss_h;
  int b, s, h, t, k;       // rows per tensor = b * s * h
};

// the source and destination of row r (< 2^31) of tensor `which`, or
// false where the row is not written (the kernels take their Rows as a
// __grid_constant__, and select rather than index, so that no thread
// copies the parameters to local memory)
__device__ __forceinline__ bool place(const Rows& p, int r, int which,
                                      const void** src, signed char** q,
                                      float** sc) {
  const int hh = r % p.h, bi = r / p.h;
  const int i = bi % p.s, bb = bi / p.s;
  int slot;
  if (p.slot_ptr != nullptr) {
    slot = *p.slot_ptr;
  } else {
    if (i < p.s - p.t) return false;
    slot = i % p.t;
  }
  *src = which ? p.src[1] : p.src[0];
  *q = (which ? p.q[1] : p.q[0]) + bb * p.qs_b + slot * p.qs_t +
       hh * p.qs_h;
  *sc = (which ? p.scale[1] : p.scale[0]) + bb * p.ss_b + slot * p.ss_t +
        hh * p.ss_h;
  return true;
}

__device__ __forceinline__ int code(float x, float s) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

// VB bytes of T (16 or 8) as E = VB / sizeof(T) floats; bf16 -> f32 is the
// upper 16 bits of the word
template <typename T, int VB>
struct Vec {
  static constexpr int E = VB / (int)sizeof(T);
  __device__ static void load(const void* p, float (&v)[E]) {
    unsigned w[VB / 4];
    if constexpr (VB == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    }
#pragma unroll
    for (int j = 0; j < VB / 4; ++j) {
      if constexpr (sizeof(T) == 4) {
        v[j] = __uint_as_float(w[j]);
      } else {
        v[2 * j] = __uint_as_float(w[j] << 16);
        v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
};

// E codes packed into one E-byte store (E = 8, 4 or 2)
template <int E>
__device__ __forceinline__ void store(signed char* q, const int (&c)[E]) {
  unsigned w[(E + 3) / 4] = {};
#pragma unroll
  for (int e = 0; e < E; ++e) w[e / 4] |= (unsigned)(c[e] & 0xff) << (8 * (e % 4));
  if constexpr (E == 8) {
    *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
  } else if constexpr (E == 4) {
    *reinterpret_cast<uint32_t*>(q) = w[0];
  } else {
    *reinterpret_cast<uint16_t*>(q) = (uint16_t)w[0];
  }
}

// row r of a standalone quant (KV false: rows of x to rows of q), or
// place()'s row of the KV write
template <bool KV>
__device__ __forceinline__ bool row_of(const Rows& p, int r, int which,
                                       const void** x, signed char** q,
                                       float** sc) {
  if (r >= p.b * p.s * p.h) return false;
  if constexpr (KV) return place(p, r, which, x, q, sc);
  *x = p.src[0];
  *q = p.q[0] + (long long)r * p.k;
  *sc = p.scale[0] + r;
  return true;
}

// g lanes a row (blockDim / g rows a block), R VB-byte vectors a lane
template <typename T, int VB, int R, bool KV>
__global__ void __launch_bounds__(kThreads)
quant_vec_kernel(const __grid_constant__ Rows p, int g, float inv_qmax) {
  using V = Vec<T, VB>;
  constexpr int E = V::E;
  const int which = blockIdx.y;
  const int lane = threadIdx.x & 31, gl = lane & (g - 1);
  const unsigned mask =
      g == 32 ? 0xffffffffu : ((1u << g) - 1) << (lane & ~(g - 1));
  const int r = (blockIdx.x * kThreads + threadIdx.x) / g;
  const void* x;
  signed char* q;
  float* sc;
  if (!row_of<KV>(p, r, which, &x, &q, &sc)) return;      // whole groups
  const int nv = p.k / E;                                   // vectors a row
  const char* src = reinterpret_cast<const char*>(x) +
                    (long long)r * p.k * (long long)sizeof(T);
  float v[R][E];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int vi = gl + j * g;
    if (vi < nv) {
      V::load(src + (long long)VB * vi, v[j]);
#pragma unroll
      for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(v[j][e]));
    }
  }
  for (int o = g / 2; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(mask, amax, o));
  const float s = fmaxf(amax, 1e-8f) * inv_qmax;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int vi = gl + j * g;
    if (vi < nv) {
      int c[E];
#pragma unroll
      for (int e = 0; e < E; ++e) c[e] = code(v[j][e], s);
      store<E>(q + (long long)E * vi, c);
    }
  }
  if (gl == 0) *sc = s;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// one warp a row, any K and alignment; the row is read twice
template <typename T, bool KV>
__global__ void __launch_bounds__(kThreads)
quant_scalar_kernel(const __grid_constant__ Rows p, float inv_qmax) {
  const int which = blockIdx.y, lane = threadIdx.x & 31;
  const int r = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const void* x;
  signed char* q;
  float* sc;
  if (!row_of<KV>(p, r, which, &x, &q, &sc)) return;      // whole warps
  const T* xr = reinterpret_cast<const T*>(x) + (long long)r * p.k;
  float amax = 0.f;
  for (int i = lane; i < p.k; i += 32) amax = fmaxf(amax, fabsf(load1(xr + i)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = fmaxf(amax, 1e-8f) * inv_qmax;
  for (int i = lane; i < p.k; i += 32) q[i] = (signed char)code(load1(xr + i), s);
  if (lane == 0) *sc = s;
}

template <typename T, int VB, bool KV>
int launch(const Rows& p, int tensors, int g, int r, float inv_qmax,
           cudaStream_t stream) {
  const long long rows = (long long)p.b * p.s * p.h;
  if (rows * 32 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int lanes = r == 0 ? 32 : g;
  const long long blocks = (rows * lanes + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  dim3 grid((unsigned)blocks, tensors);
  switch (r) {
    case 0:
      quant_scalar_kernel<T, KV><<<grid, kThreads, 0, stream>>>(p, inv_qmax);
      break;
#define REPRO_R(RR)                                                          \
  case RR:                                                                   \
    quant_vec_kernel<T, VB, RR, KV><<<grid, kThreads, 0, stream>>>(          \
        p, g, inv_qmax);                                                     \
    break;
    REPRO_R(1) REPRO_R(2) REPRO_R(4) REPRO_R(8)
#undef REPRO_R
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool KV>
int launch_kv(const Rows& p, int f32, int tensors, int vb, int g, int r,
              float inv_qmax, cudaStream_t st) {
  if (r == 0) vb = 16;                 // the scalar path reads no vectors
  if (vb != 8 && vb != 16) return (int)cudaErrorInvalidValue;
  if (f32)
    return vb == 16 ? launch<float, 16, KV>(p, tensors, g, r, inv_qmax, st)
                    : launch<float, 8, KV>(p, tensors, g, r, inv_qmax, st);
  return vb == 16
             ? launch<__nv_bfloat16, 16, KV>(p, tensors, g, r, inv_qmax, st)
             : launch<__nv_bfloat16, 8, KV>(p, tensors, g, r, inv_qmax, st);
}

int dispatch(bool kv, int f32, const void* src0, const void* src1, void* q0,
             void* q1, void* s0, void* s1, const void* slot, int b, int s,
             int h, int t, int k, long long qs_b, long long qs_t,
             long long qs_h, long long ss_b, long long ss_t, long long ss_h,
             int vb, int g, int r, float inv_qmax, void* stream) {
  Rows p{{src0, src1},
         {(signed char*)q0, (signed char*)q1},
         {(float*)s0, (float*)s1},
         (const int*)slot, qs_b, qs_t, qs_h, ss_b, ss_t, ss_h, b, s, h, t, k};
  const int tensors = src1 != nullptr ? 2 : 1;
  cudaStream_t st = (cudaStream_t)stream;
  return kv ? launch_kv<true>(p, f32, tensors, vb, g, r, inv_qmax, st)
            : launch_kv<false>(p, f32, tensors, vb, g, r, inv_qmax, st);
}

}  // namespace

// x [M, K] -> q [M, K], scale [M, 1].  vb-byte vectors, g lanes a row and
// r vectors a lane (kernels/quant.py plan; r = 0: the scalar path).
extern "C" int rowwise_quant(int f32, const void* x, void* q, void* scale,
                             int m, int k, int vb, int g, int r,
                             float inv_qmax, void* stream) {
  return dispatch(false, f32, x, nullptr, q, nullptr, scale, nullptr,
                  nullptr, m, 1, 1, 1, k, k, 0, 0, 1, 0, 0, vb, g, r,
                  inv_qmax, stream);
}

// k, v [B, S, H, K] -> codes and scales of the int8 KV cache, in place
// (strides in elements; the k and v buffers share them).  slot: a device
// int32 for decode (S = 1), or null for the prefill layout over T slots.
extern "C" int rowwise_quant_kv(int f32, const void* k, const void* v,
                                void* kq, void* vq, void* ks, void* vs,
                                const void* slot, int b, int s, int h, int t,
                                int hd, long long qs_b, long long qs_t,
                                long long qs_h, long long ss_b,
                                long long ss_t, long long ss_h, int vb,
                                int g, int r, float inv_qmax, void* stream) {
  return dispatch(true, f32, k, v, kq, vq, ks, vs, slot, b, s, h, t, hd,
                  qs_b, qs_t, qs_h, ss_b, ss_t, ss_h, vb, g, r, inv_qmax,
                  stream);
}
