// Go fixed-width integer helpers for the CUDA kernels.
//
// Counterpart of saprobe_alac_tpu/ops/jaxint.py and the clamped shifts of
// native/alac_core.cpp:39-52.  A C++ shift by 32 or more is undefined, and
// so is signed overflow, so wrapping arithmetic goes through uint32_t and
// every shift count is clamped: counts of 32 or more (or negative, which
// Go's uint32 counts make huge) give 0, or sign fill for sshr32.
#pragma once

#include <cstdint>

namespace alac {

__device__ __forceinline__ uint32_t shl32(uint32_t x, int32_t n) {
  return (n >= 32 || n < 0) ? 0u : x << n;
}

__device__ __forceinline__ uint32_t ushr32(uint32_t x, int32_t n) {
  return (n >= 32 || n < 0) ? 0u : x >> n;
}

__device__ __forceinline__ int32_t sshr32(int32_t x, int32_t n) {
  return (n >= 32 || n < 0) ? (x < 0 ? -1 : 0) : (x >> n);
}

// Go (x << (32-bits)) >> (32-bits); bits > 32 gives 0.
__device__ __forceinline__ int32_t sext(int32_t x, int32_t bits) {
  int32_t cs = 32 - bits;
  if (cs < 0) return 0;
  return sshr32(static_cast<int32_t>(shl32(static_cast<uint32_t>(x), cs)), cs);
}

__device__ __forceinline__ int32_t sext16(int32_t x) { return sext(x, 16); }

// Leading zeros of the 32-bit pattern; 32 for 0.
__device__ __forceinline__ int32_t clz32(int32_t x) { return __clz(x); }

// floor(log2(x+3)) (golomb.go:74-76).
__device__ __forceinline__ int32_t lg3a(int32_t x) {
  return 31 - clz32(static_cast<int32_t>(static_cast<uint32_t>(x) + 3u));
}

// Wrapping int32 add, sub and mul.
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sgn(int32_t x) { return (x > 0) - (x < 0); }

}  // namespace alac
