// fleetlint fixture: the C side of kernel_bad.py.
#include <cuda_runtime.h>

__global__ void axpy_kernel(const float* x, float* y, int n, float scale,
                            const int* __restrict__ table) {
  const int* row = table + blockIdx.x;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int blk = row[i / 16];                   // KRN009: -1 unguarded
  if (i < n) y[i] = x[i] * scale + blk * 0;
}

// KRN005: n is a 64-bit count here; KRN006: no int status
extern "C" void axpy_f32(const void* x, void* y, long long n, float scale,
                         void* stream) {
  axpy_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, (int)n, scale, nullptr);
}
