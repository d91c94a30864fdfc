// Raw reader kernel: fixed-stride bit fields, the 24/32-bit shift region.
//
// Replaces the TPU kernel saprobe_alac_tpu/ops/walk_kernel.py:1252
// `_raw_reader_kernel` (entry `raw_read_pallas`).  out[t][b] is the
// width[b]-bit field at bit base[b] + t*step[b] of packet b, for t < n[b] on
// active lanes, sign-extended when is_signed; 0 on every other row of the
// (F_pad, B) F-major output.  Words outside [0, W) read as zero
// (bitbuffer.go:28-32), so a field that straddles the last column reads the
// guard words or zeros.
//
// What bounds it on an H100: bytes.  Each output is independent of every
// other (no serial dependency, unlike the walk), so the kernel is a gather
// that reads the shift region once and writes the output plane once.  At the
// hi-res shapes (B=2048 packets of F=4096, stereo, bytesShifted=1, the pair
// read as one 16-bit field) that is 16.8 MB read and 33.6 MB written, about
// 15 us at 3.35 TB/s.
//
// Layout and coalescing: one thread serves one lane (packet) for kRows
// consecutive rows, lanes on threadIdx.x.  At each row the 32 threads of a
// warp store 32 adjacent int32 of row t: one 128-byte store.  The loads are
// scattered across the warp (each lane is its own packet row), but a
// thread's kRows fields are contiguous in its packet (kRows * step <= 1024
// bits), so after the first row its loads hit the lines already in L1, and
// device memory sees each sector of the shift region about once.  A
// shared-memory transpose tile would make the loads coalesce as well; that
// is the next step if the kernel shows up in a trace.  Shift counts go
// through the clamped helpers of alac_int.cuh: a 32-bit field (the pair
// fusion at bytesShifted=2) shifts by 0 and by 32.

#include <cuda_runtime.h>

#include <cstdint>

#include "alac_int.cuh"

namespace {

using namespace alac;

constexpr int kThreads = 128;
constexpr int kRows = 16;

__device__ __forceinline__ uint32_t word_at(const int32_t* row, int64_t i, int W) {
  return (i >= 0 && i < W) ? static_cast<uint32_t>(__ldg(row + i)) : 0u;
}

__global__ void __launch_bounds__(kThreads) raw_reader_kernel(
    const int32_t* __restrict__ words, int W, const int32_t* __restrict__ base,
    const int32_t* __restrict__ step, const int32_t* __restrict__ width,
    const int32_t* __restrict__ act, const int32_t* __restrict__ n,
    int32_t* __restrict__ out, int B, int F_pad, int is_signed) {
  const int lane_blocks = (B + kThreads - 1) / kThreads;
  const int b = static_cast<int>(blockIdx.x % lane_blocks) * kThreads + threadIdx.x;
  const int t0 = static_cast<int>(blockIdx.x / lane_blocks) * kRows;
  if (b >= B) return;
  const int32_t rows = act[b] != 0 ? n[b] : 0;
  const int64_t stp = step[b];
  const int32_t w = width[b];
  const int32_t cut = 32 - (w < 1 ? 1 : w);
  const int32_t* row = words + static_cast<size_t>(b) * W;
  int64_t pos = base[b] + static_cast<int64_t>(t0) * stp;
  for (int j = 0; j < kRows; ++j) {
    const int t = t0 + j;
    if (t >= F_pad) break;
    int32_t v = 0;
    if (t < rows) {
      const int64_t wi = pos >> 5;
      const int32_t r = static_cast<int32_t>(pos & 31);
      const uint32_t win =
          shl32(word_at(row, wi, W), r) | ushr32(word_at(row, wi + 1, W), 32 - r);
      v = is_signed ? sshr32(static_cast<int32_t>(win), cut)
                    : static_cast<int32_t>(ushr32(win, cut));
    }
    out[static_cast<size_t>(t) * B + b] = v;
    pos += stp;
  }
}

}  // namespace

extern "C" int alac_raw_read_launch(const void* words, int W, const void* base,
                                    const void* step, const void* width, const void* act,
                                    const void* n, void* out, int B, int F_pad, int is_signed,
                                    void* stream) {
  const int lane_blocks = (B + kThreads - 1) / kThreads;
  const int blocks = lane_blocks * ((F_pad + kRows - 1) / kRows);
  if (blocks > 0) {
    raw_reader_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), W, static_cast<const int32_t*>(base),
        static_cast<const int32_t*>(step), static_cast<const int32_t*>(width),
        static_cast<const int32_t*>(act), static_cast<const int32_t*>(n),
        static_cast<int32_t*>(out), B, F_pad, is_signed);
  }
  return static_cast<int>(cudaGetLastError());
}
