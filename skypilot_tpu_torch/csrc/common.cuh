// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel source under csrc/ is built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into its own shared library with a plain C interface, loaded with
// ctypes. A C entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace skyt {

// Masked-score sentinel of the TPU kernels (ops/flash_attention.py and
// ops/paged_attention.py NEG_INF): finite, so m_prev - m_new never
// produces inf - inf.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Asynchronous 16-byte global -> shared copy (cp.async, sm_80+): a
// thread issues all of its copies without waiting on any of them.
// src_bytes 0 fills the destination with zeros and reads nothing (src
// must still be a valid address).
__device__ __forceinline__ void cp_async16(void *smem, const void *gmem,
                                           int src_bytes = 16) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// Wait for every cp.async this thread issued (then __syncthreads() to
// see the other threads' copies).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Round a float to bf16 and back: the TPU kernels cast the softmax
// weights p to the value dtype before the PV product.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace skyt

// Each library exports its own copy (they are loaded RTLD_LOCAL).
#define SKYT_DEFINE_ERROR_STRING                                  \
  extern "C" const char *skyt_error_string(int code) {            \
    return cudaGetErrorString(static_cast<cudaError_t>(code));    \
  }
