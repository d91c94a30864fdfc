// Host stand-ins for the CUDA built-ins the port's kernels use, so that
// saprobe_alac_tpu_torch/csrc/*.cu compiles as plain C++ (g++) and each
// kernel's code runs on the CPU.  tests/test_torch_csrc_host.py force-includes
// this header and rewrites every `kernel<<<grid, block, 0, stream>>>(args)`
// launch into a loop over blocks and threads that calls the kernel as a
// function.  Those kernels use no shared memory, no barriers and no warp
// shuffles, so running their threads one after another computes what the
// card computes.  A kernel with shared memory and `__syncthreads` (the
// epilogue kernel) is launched through `host_launch_threads` instead: each
// block's threads run at once, one host thread each, `__shared__` variables
// are function statics (one block runs at a time) and `__syncthreads` is a
// barrier over the block's threads.
#pragma once

#include <algorithm>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static

struct HostDim3 {
  unsigned x, y, z;
};
static HostDim3 blockIdx, blockDim;
static thread_local HostDim3 threadIdx;

struct HostBarrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned count = 0, waiting = 0, generation = 0;
};

inline HostBarrier& host_barrier() {
  static HostBarrier b;
  return b;
}

inline void __syncthreads() {
  HostBarrier& b = host_barrier();
  std::unique_lock<std::mutex> lock(b.m);
  const unsigned gen = b.generation;
  if (++b.waiting == b.count) {
    b.waiting = 0;
    ++b.generation;
    b.cv.notify_all();
  } else {
    b.cv.wait(lock, [&] { return b.generation != gen; });
  }
}

// `body` (the kernel call) on grid blocks of `block` threads, the blocks one
// after another, each block's threads at once.
template <class Body>
void host_launch_threads(unsigned grid, unsigned block, Body body) {
  blockDim.x = block;
  host_barrier().count = block;
  for (blockIdx.x = 0; blockIdx.x < grid; ++blockIdx.x) {
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t) {
      threads.emplace_back([t, &body] {
        threadIdx.x = t;
        body();
      });
    }
    for (auto& th : threads) th.join();
  }
}

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
