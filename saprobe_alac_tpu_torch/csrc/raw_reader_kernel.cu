// Raw reader kernel: fixed-stride bit fields, the 24/32-bit shift region.
//
// Replaces the TPU kernel saprobe_alac_tpu/ops/walk_kernel.py:1252
// `_raw_reader_kernel` (entry `raw_read_pallas`).  out[t][l] is the
// width[l]-bit field at bit base[l] + t*step[l] of packet row[l], for
// t < n[l] on active lanes, sign-extended when is_signed; 0 on every other
// row of the (F_pad, L) F-major output.  Words outside [0, W) read as zero
// (bitbuffer.go:28-32), so a field that straddles the last column reads the
// guard words or zeros; a lane whose row lies outside [0, B) reads zeros.
// The row map lets one launch serve every channel of a batch (lanes
// channel-major, each carrying its packet's row).
//
// What bounds it on an H100: bytes.  Each output is independent of every
// other, so the kernel is a gather that reads the shift region once and
// writes the output plane once; at the hi-res shapes (B=2048 packets of
// F=4096, stereo, bytesShifted=1: the pair read as one 16-bit field on the
// U lanes, nothing on the V lanes) that is 16.8 MB read and 67 MB written.
//
// Layout: one thread serves one lane for kRows consecutive rows, lanes on
// threadIdx.x, so at each row a warp stores 32 adjacent int32: one 128-byte
// store.  A thread's kRows fields are contiguous in its packet, so it reads
// them with a few aligned 16-byte loads (`fields`): the words from the
// aligned chunk below its first field on, shifted once so the first field
// starts at bit 0 of a register, after which field j sits at bit j*STEP of
// a compile-time register (the steps a valid stream sends, 8, 16 and 32,
// are template arguments; any other step, such as the 24 of a corrupt
// packet whose planes the host redoes, takes one scalar read a field,
// `fields_any`).
// No register array is indexed at run time, so nothing lives in local
// memory.  A warp's load touches one line per lane (each lane is its own
// packet), so what the design cuts is the count of load instructions: a
// few a thread for its 32 fields.

#include <cuda_runtime.h>

#include <cstdint>

#include "alac_int.cuh"

namespace {

using namespace alac;

constexpr int kThreads = 128;
// Rows a thread reads: on the H100 32 read the 7.1 batch 4% faster than 16
// and the hi-res one alike (PERF.md).
constexpr int kRows = 32;

// One packet's words, [0, W) of the flat buffer from `start`; zero outside.
struct Packet {
  const int32_t* words;  // the whole (B, W) buffer
  int64_t start;         // row * W, flat index of the packet's word 0
  int64_t W;             // 0 for a lane whose row is out of range
  bool vec;              // the buffer is 16-byte aligned

  __device__ __forceinline__ uint32_t word(int64_t i) const {
    return (i >= 0 && i < W) ? static_cast<uint32_t>(__ldg(words + start + i)) : 0u;
  }
  // Words i .. i + 3 (i a multiple of 4 in the flat buffer): one 16-byte
  // load when all four lie in the packet, else word by word.
  __device__ __forceinline__ void chunk(int64_t i, uint32_t* out) const {
    if (vec && i >= 0 && i + 4 <= W) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(words + start + i));
      out[0] = v.x;
      out[1] = v.y;
      out[2] = v.z;
      out[3] = v.w;
    } else {
      for (int k = 0; k < 4; ++k) out[k] = word(i + k);
    }
  }
};

// The field in the 32 bits at the top of `win`, cut to its width:
// ``cut`` = 32 - width, already mapped to a shift of 0..31 (signed) or
// 0..32 (unsigned) with the clamped semantics of alac_int.cuh.
__device__ __forceinline__ int32_t cut_field(uint32_t win, int32_t cu, int32_t cs, bool sgn) {
  return sgn ? (static_cast<int32_t>(win) >> cs)
             : static_cast<int32_t>(__funnelshift_rc(win, 0u, static_cast<uint32_t>(cu)));
}

// kRows fields STEP bits apart from bit `pos` of the packet.
template <int STEP>
__device__ __forceinline__ void fields(const Packet& pk, int64_t pos, int32_t cu, int32_t cs,
                                       bool sgn, int32_t* v) {
  // Words the fields span once the first starts at bit 0, and the raw
  // words behind them: up to 3 words and 31 bits of alignment below.
  constexpr int kWords = ((kRows - 1) * STEP) / 32 + 2;
  constexpr int kChunks = (kWords + 4 + 3) / 4;
  const int64_t wi = pos >> 5;
  // The 16-byte chunk of the flat buffer holding word wi.
  const int64_t c0 = ((pk.start + wi) & ~int64_t{3}) - pk.start;
  const int32_t o = static_cast<int32_t>(pos - c0 * 32);  // 0..127
  uint32_t a[kChunks * 4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) pk.chunk(c0 + 4 * c, a + 4 * c);
  // b[i] = the 32 bits at o + 32 i: whole words picked by selects on
  // o >> 5, then one funnel shift by o & 31.
  const bool d1 = (o & 32) != 0, d2 = (o & 64) != 0;
  const uint32_t r = static_cast<uint32_t>(o & 31);
  uint32_t sel[kWords + 1];
#pragma unroll
  for (int i = 0; i <= kWords; ++i) {
    const uint32_t y0 = d1 ? a[i + 1] : a[i];
    const uint32_t y2 = d1 ? a[i + 3] : a[i + 2];
    sel[i] = d2 ? y2 : y0;
  }
  uint32_t b[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) b[i] = __funnelshift_l(sel[i + 1], sel[i], r);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int bit = j * STEP;
    const uint32_t win = (bit & 31) == 0 ? b[bit >> 5]
                                         : __funnelshift_l(b[(bit >> 5) + 1], b[bit >> 5], bit & 31);
    v[j] = cut_field(win, cu, cs, sgn);
  }
}

// Any step: one two-word read a field.
__device__ __forceinline__ void fields_any(const Packet& pk, int64_t pos, int64_t stp, int32_t cu,
                                           int32_t cs, bool sgn, int32_t* v) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int64_t wi = pos >> 5;
    const int32_t r = static_cast<int32_t>(pos & 31);
    const uint32_t win = shl32(pk.word(wi), r) | ushr32(pk.word(wi + 1), 32 - r);
    v[j] = cut_field(win, cu, cs, sgn);
    pos += stp;
  }
}

__global__ void __launch_bounds__(kThreads) raw_reader_kernel(
    const int32_t* __restrict__ words, int W, int B, const int32_t* __restrict__ row,
    const int32_t* __restrict__ base, const int32_t* __restrict__ step,
    const int32_t* __restrict__ width, const int32_t* __restrict__ act,
    const int32_t* __restrict__ n, int32_t* __restrict__ out, int L, int F_pad, int is_signed) {
  const int lane_blocks = (L + kThreads - 1) / kThreads;
  const int l = static_cast<int>(blockIdx.x % lane_blocks) * kThreads + threadIdx.x;
  const int t0 = static_cast<int>(blockIdx.x / lane_blocks) * kRows;
  if (l >= L) return;
  const int32_t rows = act[l] != 0 ? n[l] : 0;
  int32_t v[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) v[j] = 0;
  if (t0 < rows) {
    const int32_t p = row != nullptr ? row[l] : l;
    const bool inside = p >= 0 && p < B;
    const Packet pk{words, inside ? static_cast<int64_t>(p) * W : 0, inside ? W : 0,
                    (reinterpret_cast<uintptr_t>(words) & 15) == 0};
    const int32_t stp = step[l];
    const int32_t w = width[l];
    const int32_t cut = 32 - (w < 1 ? 1 : w);
    // shl32 / ushr32 / sshr32 give 0 or sign fill for a count outside 0..31.
    const bool in_range = cut >= 0 && cut < 32;
    const int32_t cu = in_range ? cut : 32, cs = in_range ? cut : 31;
    const bool sgn = is_signed != 0;
    const int64_t pos = base[l] + static_cast<int64_t>(t0) * stp;
    switch (stp) {
      case 8: fields<8>(pk, pos, cu, cs, sgn, v); break;
      case 16: fields<16>(pk, pos, cu, cs, sgn, v); break;
      case 32: fields<32>(pk, pos, cu, cs, sgn, v); break;
      default: fields_any(pk, pos, stp, cu, cs, sgn, v);
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int t = t0 + j;
    if (t < F_pad) out[static_cast<size_t>(t) * L + l] = t < rows ? v[j] : 0;
  }
}

}  // namespace

extern "C" int alac_raw_read_launch(const void* words, int W, int B, const void* row,
                                    const void* base, const void* step, const void* width,
                                    const void* act, const void* n, void* out, int L, int F_pad,
                                    int is_signed, void* stream) {
  const int lane_blocks = (L + kThreads - 1) / kThreads;
  const int blocks = lane_blocks * ((F_pad + kRows - 1) / kRows);
  if (blocks > 0) {
    raw_reader_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), W, B, static_cast<const int32_t*>(row),
        static_cast<const int32_t*>(base), static_cast<const int32_t*>(step),
        static_cast<const int32_t*>(width), static_cast<const int32_t*>(act),
        static_cast<const int32_t*>(n), static_cast<int32_t*>(out), L, F_pad, is_signed);
  }
  return static_cast<int>(cudaGetLastError());
}
