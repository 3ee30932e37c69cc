// Shared by the port's kernel sources: every library exports the CUDA
// error string of a launch's return code, so the Python wrapper can raise
// with a readable message.
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
