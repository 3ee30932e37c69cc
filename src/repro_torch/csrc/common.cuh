// Shared by the port's kernel sources: every library exports the CUDA
// error string of a launch's return code, so the Python wrapper can raise
// with a readable message; and the helpers that more than one source
// uses: the shared-memory opt-in and the mbarrier wrappers.
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define NULL_ID (-1)

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The device's shared-memory limit per block (opt-in), read once.
inline int smem_block_limit() {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&cached, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return cached;
}

// Let `kernel` launch with `bytes` of dynamic shared memory: its opt-in is
// raised the first time a launch needs more than `set` (the caller's
// static, one per kernel).  cudaErrorInvalidValue past the block's limit.
inline cudaError_t allow_smem(const void* kernel, int bytes, int& set) {
  if (bytes > smem_block_limit()) return cudaErrorInvalidValue;
  if (bytes > set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    set = bytes;
  }
  return cudaSuccess;
}

// --- mbarrier wrappers (PTX) ---------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
