// Host stand-ins for the CUDA built-ins the port's kernels use, so that
// saprobe_alac_tpu_torch/csrc/*.cu compiles as plain C++ (g++) and each
// kernel's code runs on the CPU.  tests/test_torch_csrc_host.py force-includes
// this header and rewrites every `kernel<<<grid, block, 0, stream>>>(args)`
// launch into a loop over blocks and threads that calls the kernel as a
// function.  The kernels use no shared memory, no barriers and no warp
// shuffles, so running their threads one after another computes what the
// card computes.
#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)

struct HostDim3 {
  unsigned x, y, z;
};
static HostDim3 blockIdx, threadIdx, blockDim;

struct uint4 {
  unsigned x, y, z, w;
};

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

// Funnel shifts: (hi:lo) shifted by shift & 31 (wrapping form) or by
// min(shift, 32) (clamping forms).
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned shift) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<unsigned>((v << (shift & 31)) >> 32);
}
inline unsigned __funnelshift_lc(unsigned lo, unsigned hi, unsigned shift) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<unsigned>((v << (shift < 32 ? shift : 32)) >> 32);
}
inline unsigned __funnelshift_rc(unsigned lo, unsigned hi, unsigned shift) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<unsigned>(v >> (shift < 32 ? shift : 32));
}

inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x)); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
