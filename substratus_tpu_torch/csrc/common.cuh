// Shared definitions of the port's kernels: dtype codes (kept in step
// with kernels/__init__.py DTYPE_CODES), the masked-logit value and the
// opt-in to large dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace substratus {

enum DType : int { kBF16 = 0, kInt8 = 1 };

// Masked logits, as in the JAX reference (a finite value: inf - inf
// would make NaN in the online-softmax rescale).
constexpr float kNegInf = -1e30f;

// Allow `kernel` smem bytes of dynamic shared memory, once per
// instantiation (`configured` is the caller's static flag).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  configured = err == cudaSuccess;
  return err;
}

}  // namespace substratus
