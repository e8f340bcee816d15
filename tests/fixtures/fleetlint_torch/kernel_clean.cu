// fleetlint fixture: the C side of kernel_clean.py, with a guarded
// block-table read.
#include <cuda_runtime.h>

__global__ void axpy_kernel(const float* x, float* y, int n, float scale,
                            const int* __restrict__ table) {
  const int* row = table + blockIdx.x;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int blk = max(__ldg(row + i / 16), 0);   // a dead entry reads row 0
  if (i < n) y[i] = x[i] * scale + blk * 0;
}

extern "C" int axpy_f32(const void* x, void* y, int n, float scale,
                        void* stream) {
  axpy_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n, scale, nullptr);
  return (int)cudaGetLastError();
}
