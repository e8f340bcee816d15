// Row-wise absmax int8 quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel rowwise_quant_pallas (src/repro/kernels/quant.py,
// body _quant_kernel).  Per row of x [M, K] (bf16 or f32, contiguous):
//   amax  = max_k |x[k]|                      (in f32)
//   scale = max(amax, 1e-8) * inv_qmax        (inv_qmax = f32(1/127))
//   q[k]  = clamp(rint(x[k] / scale), -127, 127)   int8
// Outputs q [M, K] int8 and scale [M, 1] f32.  The scale is the product with
// the f32 reciprocal, not a division by 127: that is what XLA's jit makes of
// the reference's `/ 127.0`, and the codes match only that way.  x / scale is
// a true IEEE division (no fast math) and rint rounds half to even, as
// jnp.round does.
//
// What bounds it: each element is read once (2 or 4 bytes) and written once
// (1 byte), a handful of operations each, so it is bound by device-memory
// bytes; at the int8 KV cache's shapes (hd = 128 rows, 64 of them per decode
// layer) it is bound by the launch.  Design: one warp per row, lanes stride
// the row, a shuffle reduction gives every lane the row's absmax; the row is
// read a second time for the codes (from L1/L2: K is small).  8 rows per
// block of 256 threads; any M and K.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
rowwise_quant_kernel(const T* __restrict__ x, signed char* __restrict__ q,
                     float* __restrict__ scale, int m, int k,
                     float inv_qmax) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  if (row >= m) return;                  // whole warps leave together
  const T* xr = x + row * k;
  float amax = 0.f;
  for (int i = lane; i < k; i += 32) amax = fmaxf(amax, fabsf(load(xr + i)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax, 1e-8f) * inv_qmax;
  signed char* qr = q + row * k;
  for (int i = lane; i < k; i += 32) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(load(xr + i), s)), -127.f),
                          127.f);
    qr[i] = (signed char)(int)c;
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
int launch(const void* x, void* q, void* scale, int m, int k, float inv_qmax,
           cudaStream_t stream) {
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rowwise_quant_kernel<T><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      (const T*)x, (signed char*)q, (float*)scale, m, k, inv_qmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rowwise_quant_bf16(const void* x, void* q, void* scale, int m,
                                  int k, float inv_qmax, void* stream) {
  return launch<__nv_bfloat16>(x, q, scale, m, k, inv_qmax,
                               (cudaStream_t)stream);
}

extern "C" int rowwise_quant_f32(const void* x, void* q, void* scale, int m,
                                 int k, float inv_qmax, void* stream) {
  return launch<float>(x, q, scale, m, k, inv_qmax, (cudaStream_t)stream);
}
