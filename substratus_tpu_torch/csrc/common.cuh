// Shared definitions of the port's kernels: dtype codes (kept in step
// with kernels/__init__.py DTYPE_CODES) and the masked-logit value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace substratus {

enum DType : int { kBF16 = 0, kInt8 = 1 };

// Masked logits, as in the JAX reference (a finite value: inf - inf
// would make NaN in the online-softmax rescale).
constexpr float kNegInf = -1e30f;

}  // namespace substratus
