// The batch decoder's trim of a large batch: each device-decoded packet's
// PCM, copied from its row of the downloaded output into the caller's
// buffer (a `bytes` made uninitialised by the port's binding,
// saprobe_alac_tpu_torch/native.py).
//
// One call copies every packet once.  Across OpenMP's threads the fresh
// pages of the destinations fault in on every core at once: a caller that
// drops each batch's output lets the heap hand those pages back, and a
// batch of 2048 7.1/24-bit packets (201 MB) faults ~49,000 of them again.
//
// C ABI only; bound from Python via ctypes.

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Copy row i's first lengths[i] bytes (row i at src + i * stride) to
// dst[i], for i < count, across OpenMP's threads; a row of length <= 0 is
// skipped.  Returns the number of threads that copied.
int32_t alac_copy_rows(const uint8_t* src, int64_t stride, const int64_t* lengths,
                       uint8_t* const* dst, int32_t count) {
  int32_t threads = 1;
#pragma omp parallel
  {
#if defined(_OPENMP)
#pragma omp master
    threads = omp_get_num_threads();
#endif
#pragma omp for schedule(static)
    for (int32_t i = 0; i < count; ++i)
      if (lengths[i] > 0) std::memcpy(dst[i], src + i * stride, lengths[i]);
  }
  return threads;
}
}
