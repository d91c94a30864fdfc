// Encode kernel: adaptive Golomb-Rice entropy encode of one channel, one
// packet per lane.
//
// Replaces the TPU kernel saprobe_alac_tpu/ops/encode_kernel.py
// `_encode_kernel` (entry `dense_encode_pallas`).  One thread runs one lane
// through the inverse of golomb.go:112-253 (the lockstep loop of
// saprobe_alac_tpu/ops/encode_device.py `_entropy_encode`): adaptive k from
// the running mean, a unary quotient prefix of at most 8 ones or the 9-one
// escape with a max_size-bit raw suffix, the k-bit remainder with the
// k == 1 and r == 0 corners, the wrapping uint32 mean update, and the
// interleaved zero-run codes with their 16-bit escape and zmode.
//
// The thread keeps its own sample cursor (a zero run jumps it) and bit
// position: bits are appended to a 64-bit register accumulator (a 9-bit
// prefix and a 32-bit suffix are 41 bits) and leave as whole 32-bit words,
// big-endian bit order, into the lane's own output row.  The TPU kernel's
// dense input schedule, output ring, freeze and drain exist because its
// vector unit cannot write at a per-lane position; a GPU thread can, so none
// of it is carried over, the quotient is a plain unsigned divide, and every
// kb > 0 is taken.
//
// What bounds it on an H100: each sample is a dependent chain (mean -> k ->
// divide -> emit -> mean) of some tens of integer ops, serial in t, so the
// kernel is latency-bound like the element walk it mirrors.  Rows n_t[t] and
// zr_t[t] are F-major, so a warp's loads coalesce while its lanes' cursors
// agree and scatter after zero runs drive them apart; the output stores are
// one word per thread into rows W words apart.
//
// The rows past a lane's last word must be zero (callers add whole bodies
// into a packet at a bit offset): the wrapper hands in a zeroed buffer and
// the kernel stores only the words it fills, the last one zero-padded.

#include <cuda_runtime.h>

#include <cstdint>

#include "alac_int.cuh"

namespace {

using namespace alac;

constexpr int kThreads = 128;

// The lane's output: a 64-bit accumulator of the bits not yet stored.
struct BitSink {
  uint32_t* row;
  int W;
  int wpos = 0;       // whole words stored (or dropped past W)
  int nacc = 0;       // pending bits, always < 32 between calls
  uint64_t acc = 0;   // pending bits in its low nacc bits (garbage above)

  // Append the low `width` (0..32) bits of `value`.
  __device__ __forceinline__ void put(uint32_t value, int32_t width) {
    width = width < 0 ? 0 : (width > 32 ? 32 : width);
    const uint32_t mask = width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
    acc = (acc << width) | (value & mask);
    nacc += width;
    if (nacc >= 32) {
      nacc -= 32;
      if (wpos < W) row[wpos] = static_cast<uint32_t>(acc >> nacc);
      ++wpos;
    }
  }

  // Store the last partial word, zero below its bits; returns the bit count.
  __device__ __forceinline__ int32_t finish() {
    if (nacc > 0 && wpos < W) row[wpos] = static_cast<uint32_t>(acc << (32 - nacc));
    return wpos * 32 + nacc;
  }
};

// One Golomb codeword: `value` against divisor m = 2^k - 1 (a signed m <= 0
// forces the escape), escape suffix `esc_bits` wide.
__device__ __forceinline__ void rice_code(BitSink& sink, uint32_t value, int32_t m, int32_t k,
                                          int32_t esc_bits) {
  const uint32_t q = m > 0 ? value / static_cast<uint32_t>(m) : 9u;
  if (q >= 9u) {  // unsigned: a quotient of 2^31 or more escapes too
    sink.put(0x1FFu, 9);
    sink.put(value, esc_bits);
    return;
  }
  sink.put((1u << (q + 1)) - 2u, static_cast<int32_t>(q) + 1);  // q ones, then a zero
  if (k == 1) return;  // the decoder skips the k-bit field
  const uint32_t r = value - q * static_cast<uint32_t>(m);
  if (r == 0) {
    sink.put(0u, k - 1);  // the decoder reads k bits, sees v < 2, consumes k - 1
  } else {
    sink.put(r + 1u, k);
  }
}

__global__ void __launch_bounds__(kThreads) encode_kernel(
    const int32_t* __restrict__ n_t, const int32_t* __restrict__ zr_t,
    const int32_t* __restrict__ act, const int32_t* __restrict__ pb_local,
    const int32_t* __restrict__ max_size, const int32_t* __restrict__ ns,
    const int32_t* __restrict__ mb, uint32_t* __restrict__ words, int32_t* __restrict__ bits,
    int32_t* __restrict__ ovf, int B, int F, int W, int kb) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int32_t nsl = min(ns[b], F);
  BitSink sink{words + static_cast<size_t>(b) * W, W};
  if (act[b] != 0 && nsl > 0) {
    const uint32_t pb = static_cast<uint32_t>(pb_local[b]);
    const int32_t esc_bits = max_size[b];
    const uint32_t wb = kb < 32 ? shl32(1u, kb) - 1u : 0xFFFFFFFFu;
    uint32_t mean = static_cast<uint32_t>(mb[b]);
    uint32_t zmode = 0;
    int32_t i = 0;
    while (i < nsl) {
      const size_t at = static_cast<size_t>(i) * B + b;
      const uint32_t n = static_cast<uint32_t>(n_t[at]);
      const uint32_t value = n - zmode;
      const int32_t k = min(lg3a(static_cast<int32_t>(mean >> 9)), kb);
      rice_code(sink, value, static_cast<int32_t>(shl32(1u, k) - 1u), k, esc_bits);
      ++i;
      mean = pb * n + mean - ((pb * mean) >> 9);
      if (value > 0xFFFFu) mean = 0xFFFFu;
      zmode = 0;

      // Zero-run mode (the mirror of golomb.go:223-246): code the run of
      // zeros that starts at the next sample, and jump the cursor over it.
      if ((mean << 2) < 512u && i < nsl) {
        const int32_t k32 = max(
            clz32(static_cast<int32_t>(mean)) - 24 + static_cast<int32_t>((mean + 16u) >> 6), 0);
        const int32_t mz = static_cast<int32_t>((shl32(1u, k32) - 1u) & wb);
        const int32_t run = min(max(zr_t[at], 0), 65535);
        rice_code(sink, static_cast<uint32_t>(run), mz, k32, 16);
        i += run;
        zmode = run >= 65535 ? 0u : 1u;
        mean = 0;
      }
    }
  }
  const int32_t nbits = sink.finish();
  bits[b] = nbits;
  ovf[b] = nbits > W * 32;  // the caller's sizing rules this out
}

}  // namespace

extern "C" int alac_encode_launch(const void* n_t, const void* zr_t, const void* act,
                                  const void* pb_local, const void* max_size, const void* ns,
                                  const void* mb, void* words, void* bits, void* ovf, int B,
                                  int F, int W, int kb, void* stream) {
  if (B > 0) {
    encode_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(n_t), static_cast<const int32_t*>(zr_t),
        static_cast<const int32_t*>(act), static_cast<const int32_t*>(pb_local),
        static_cast<const int32_t*>(max_size), static_cast<const int32_t*>(ns),
        static_cast<const int32_t*>(mb), static_cast<uint32_t*>(words),
        static_cast<int32_t*>(bits), static_cast<int32_t*>(ovf), B, F, W, kb);
  }
  return static_cast<int>(cudaGetLastError());
}
