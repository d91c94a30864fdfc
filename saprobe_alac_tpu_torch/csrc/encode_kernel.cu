// Encode kernel: adaptive Golomb-Rice entropy encode, one residual row per
// lane.
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
// A lane reads the residual row ``row[l]`` of n_t / zr_t (F, R), so one
// launch serves every channel of an element and every pbFactor candidate:
// lanes differ in their row and their pb_local, and no row is copied per
// candidate.  The TPU kernel's dense input schedule, output ring, freeze and
// drain exist because its vector unit cannot write at a per-lane position; a
// GPU thread can, so none of it is carried over, and every kb > 0 is taken.
//
// What bounds it on an H100: each sample is a dependent chain (mean -> k ->
// code -> mean) serial in t, so the kernel is latency-bound; a warp is alone
// on its scheduler, and a sample costs its chain.  The design keeps the chain
// short:
// - samples are coded in blocks of kAhead, the next block's rows loaded into
//   registers at the top of this one, on the assumption that no zero run
//   moves the cursor (in music a run needs mean < 128, so it is rare); a
//   zero run ends the block, is coded once below it and reloads the rows at
//   the new cursor.  zr_t is loaded only when a run is coded.  Rows are
//   F-major, so a warp's loads are one 128-byte line while its lanes'
//   cursors agree.  The block is unrolled, so the run code and the reload
//   stay outside it: on the H100 a form that coded each run inside the
//   block, a loop of 2,773 SASS instructions against 1,121, ran 2.9x
//   slower (PERF.md), plausibly from instruction fetch;
// - no divide: a quotient is wanted only below 9 and every divisor is
//   2^j - 1, so `rice_quotient` is a shift form, exact for v < 9(2^j - 1);
// - a sample codeword (prefix <= 9 bits, suffix <= k <= 23 bits) is one
//   field of at most 32 bits, appended to a 64-bit accumulator with one
//   conditional word store; only escapes and zero-run codes (widths past 32
//   there, from a wrapped mean) take the clamping two-field path.
//
// The rows past a lane's last word must be zero (callers add whole bodies
// into a packet at a bit offset): the wrapper hands in a zeroed buffer and
// the kernel stores only the words it fills, the last one zero-padded.

#include <cuda_runtime.h>

#include <cstdint>

#include "alac_int.cuh"

namespace {

using namespace alac;

// Threads a block, one lane each: a latency-bound chain wants each warp
// alone on its scheduler, and small blocks spread the lanes over the most
// SMs; on the H100 64 and 128 ran 5% slower (PERF.md).
constexpr int kThreads = 32;
// Samples a block, and rows loaded a block ahead: 4 and 16 ran 6% slower.
constexpr int kAhead = 8;

// v / (2^j - 1) for v < 9 (2^j - 1) and 1 <= j <= 23, without a divide.
// j >= 3: with v = q m + r (m = 2^j - 1, 0 <= r < m), v + (v >> j) + 1 is
// q 2^j + r + 1 + (v >> j) - q, and q - 1 <= v >> j <= q while q <= 2^j, so
// the excess lies in [r, r + 1], inside [0, 2^j): the shift by j is exact.
// j == 2 (q up to 8 > 4): 11/32 is 1/3 within 1/96, exact below 27; j == 1:
// the divisor is 1.  tests/test_torch_csrc_host.py checks every such v for
// j <= 18 and the edges of each quotient beyond.
__device__ __forceinline__ uint32_t rice_quotient(uint32_t v, int32_t j) {
  const uint32_t q = (v + (v >> j) + 1u) >> j;
  return j >= 3 ? q : (j == 2 ? (v * 11u) >> 5 : v);
}

// The lane's output: a 64-bit accumulator of the bits not yet stored.
struct BitSink {
  uint32_t* row;
  int W;
  int wpos = 0;       // whole words stored (or dropped past W)
  int nacc = 0;       // pending bits, always < 32 between calls
  uint64_t acc = 0;   // pending bits in its low nacc bits (garbage above)

  // Append the `width` (0..32) bits of `value`, which has no bit above them.
  __device__ __forceinline__ void put(uint32_t value, int32_t width) {
    acc = (acc << width) | value;
    nacc += width;
    if (nacc >= 32) {
      nacc -= 32;
      if (wpos < W) row[wpos] = static_cast<uint32_t>(acc >> nacc);
      ++wpos;
    }
  }

  // Append the low `width` bits of `value`, width clamped to 0..32.
  __device__ __forceinline__ void put_clamped(uint32_t value, int32_t width) {
    width = width < 0 ? 0 : (width > 32 ? 32 : width);
    put(width >= 32 ? value : value & ((1u << width) - 1u), width);
  }

  // Store the last partial word, zero below its bits; returns the bit count.
  __device__ __forceinline__ int32_t finish() {
    if (nacc > 0 && wpos < W) row[wpos] = static_cast<uint32_t>(acc << (32 - nacc));
    return wpos * 32 + nacc;
  }
};

// The escape: nine ones, then `value` in `esc_bits` raw bits.
__device__ __forceinline__ void escape(BitSink& sink, uint32_t value, int32_t esc_bits) {
  sink.put(0x1FFu, 9);
  sink.put_clamped(value, esc_bits);
}

// One Golomb codeword of a sample: `value` against m = 2^k - 1, 1 <= k <= 23.
__device__ __forceinline__ void sample_code(BitSink& sink, uint32_t value, int32_t k,
                                            int32_t esc_bits) {
  const uint32_t m = (1u << k) - 1u;
  if (value >= 9u * m) {  // 9m < 2^27: no overflow
    escape(sink, value, esc_bits);
    return;
  }
  const uint32_t q = rice_quotient(value, k);
  const uint32_t r = value - (q << k) + q;
  // q ones and a zero, then the remainder: k - 1 zero bits for r == 0 (the
  // decoder reads k bits, sees v < 2 and consumes k - 1), else r + 1 in k
  // bits; at k == 1, r is 0 and the suffix is empty.
  const int32_t sw = r == 0 ? k - 1 : k;
  const uint32_t code = (((1u << (q + 1)) - 2u) << sw) | (r == 0 ? 0u : r + 1u);
  sink.put(code, static_cast<int32_t>(q) + 1 + sw);  // at most 9 + 23 bits
}

// The zero-run codeword: `run` against the divisor (2^k32 - 1) & wb, i.e.
// 2^j - 1 with j = min(k32, kb) (a divisor of 0, or all 32 bits set, which
// reads as -1, forces the escape); the suffix is k32 bits wide, clamped.
__device__ __forceinline__ void run_code(BitSink& sink, uint32_t run, int32_t k32, int32_t kb) {
  const int32_t j = min(k32, kb);
  // run < 2^16, so from j = 17 on the quotient is 0: the quotient's j is
  // capped there, and 9 (2^j - 1) fits 32 bits.
  const int32_t jq = min(j, 17);
  if (j == 0 || j >= 32 || run >= 9u * ((1u << jq) - 1u)) {
    escape(sink, run, 16);
    return;
  }
  const uint32_t q = rice_quotient(run, jq);
  const uint32_t r = run - (q << j) + q;  // q == 0 whenever j > jq
  sink.put((1u << (q + 1)) - 2u, static_cast<int32_t>(q) + 1);
  if (k32 == 1) return;  // the decoder skips the k-bit field
  if (r == 0) {
    sink.put_clamped(0u, k32 - 1);
  } else {
    sink.put_clamped(r + 1u, k32);
  }
}

// One lane's residual row: sample i at p[i * R], zero at i >= F.
struct Row {
  const int32_t* p;
  int R;
  int F;

  __device__ __forceinline__ uint32_t at(int32_t i) const {
    return i < F ? static_cast<uint32_t>(__ldg(p + static_cast<size_t>(i) * R)) : 0u;
  }
};

__global__ void __launch_bounds__(kThreads) encode_kernel(
    const int32_t* __restrict__ n_t, const int32_t* __restrict__ zr_t,
    const int32_t* __restrict__ row, int R, const int32_t* __restrict__ act,
    const int32_t* __restrict__ pb_local, const int32_t* __restrict__ max_size,
    const int32_t* __restrict__ ns, const int32_t* __restrict__ mb, uint32_t* __restrict__ words,
    int32_t* __restrict__ bits, int32_t* __restrict__ ovf, int L, int F, int W, int kb) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  const int32_t col = row != nullptr ? row[l] : l;
  const int32_t nsl = min(ns[l], F);
  BitSink sink{words + static_cast<size_t>(l) * W, W};
  if (act[l] != 0 && nsl > 0 && col >= 0 && col < R) {
    const Row nr{n_t + col, R, F};
    const int32_t* zr = zr_t + col;
    const uint32_t pb = static_cast<uint32_t>(pb_local[l]);
    const int32_t esc_bits = max_size[l];
    uint32_t mean = static_cast<uint32_t>(mb[l]);
    uint32_t zmode = 0;
    int32_t i = 0;
    // q holds samples i .. i + kAhead - 1 at the top of a block, nq the next
    // block's, loaded a block ahead.
    uint32_t q[kAhead], nq[kAhead];
#pragma unroll
    for (int d = 0; d < kAhead; ++d) q[d] = nr.at(d);
    while (i < nsl) {
#pragma unroll
      for (int d = 0; d < kAhead; ++d) nq[d] = nr.at(i + kAhead + d);
      int32_t run_at = -1;  // the sample a zero run follows, if one does
#pragma unroll
      for (int s = 0; s < kAhead; ++s) {
        if (i >= nsl) break;
        const uint32_t n = q[s];
        const uint32_t value = n - zmode;
        const int32_t k = min(lg3a(static_cast<int32_t>(mean >> 9)), kb);
        sample_code(sink, value, k, esc_bits);
        const int32_t at = i++;
        mean = pb * n + mean - ((pb * mean) >> 9);
        if (value > 0xFFFFu) mean = 0xFFFFu;
        zmode = 0;
        if ((mean << 2) < 512u && i < nsl) {
          run_at = at;
          break;
        }
      }
      if (run_at < 0) {
#pragma unroll
        for (int d = 0; d < kAhead; ++d) q[d] = nq[d];
        continue;
      }
      // Zero-run mode (the mirror of golomb.go:223-246): code the run of
      // zeros that starts at the next sample, jump the cursor over it and
      // reload the queue there.
      const int32_t k32 = max(
          clz32(static_cast<int32_t>(mean)) - 24 + static_cast<int32_t>((mean + 16u) >> 6), 0);
      const int32_t run = min(max(__ldg(zr + static_cast<size_t>(run_at) * R), 0), 65535);
      run_code(sink, static_cast<uint32_t>(run), k32, kb);
      i += run;
      zmode = run >= 65535 ? 0u : 1u;
      mean = 0;
#pragma unroll
      for (int d = 0; d < kAhead; ++d) q[d] = nr.at(i + d);
    }
  }
  const int32_t nbits = sink.finish();
  bits[l] = nbits;
  ovf[l] = nbits > W * 32;  // the caller's sizing rules this out
}

}  // namespace

extern "C" int alac_encode_launch(const void* n_t, const void* zr_t, const void* row, int R,
                                  const void* act, const void* pb_local, const void* max_size,
                                  const void* ns, const void* mb, void* words, void* bits,
                                  void* ovf, int L, int F, int W, int kb, void* stream) {
  if (L > 0) {
    encode_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(n_t), static_cast<const int32_t*>(zr_t),
        static_cast<const int32_t*>(row), R, static_cast<const int32_t*>(act),
        static_cast<const int32_t*>(pb_local), static_cast<const int32_t*>(max_size),
        static_cast<const int32_t*>(ns), static_cast<const int32_t*>(mb),
        static_cast<uint32_t*>(words), static_cast<int32_t*>(bits), static_cast<int32_t*>(ovf),
        L, F, W, kb);
  }
  return static_cast<int>(cudaGetLastError());
}
