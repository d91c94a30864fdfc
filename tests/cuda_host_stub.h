// Host stand-ins for the CUDA built-ins the port's kernels use, so that
// saprobe_alac_tpu_torch/csrc/*.cu compiles as plain C++ (g++) and each
// kernel's code runs on the CPU.  tests/test_torch_csrc_host.py force-includes
// this header and rewrites every `kernel<<<grid, block, 0, stream>>>(args)`
// launch into a loop over blocks and threads that calls the kernel as a
// function.  The kernels use no shared memory and no barriers, so running
// their threads one after another computes what the card computes.
#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>

using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)

struct HostDim3 {
  unsigned x, y, z;
};
static HostDim3 blockIdx, threadIdx;

typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }

inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x)); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
