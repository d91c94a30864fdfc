// Epilogue kernel: a decoded batch's channel samples to its PCM rows, in one pass.
//
// Replaces no TPU kernel.  The JAX package computes this in XLA, outside any
// Pallas kernel (saprobe_alac_tpu/ops/epilogue.py:166-283, `_finish_planes`,
// `finish_packed`, `pack_output`, and the split after `extract_shift_kernel`'s
// raw read), and the port first did it in plain PyTorch on int64 planes
// (ops/epilogue.py, which stays as this kernel's plain twin).  On an H100 that
// took ~1,000 kernel launches and 29 ms of device time for one B=2048 7.1
// 24-bit call, which moves well under 1 GB.  This kernel does the same integer
// work in int32 registers, with wrapping done as unsigned arithmetic:
//
//   - the shift region's split: a pair's U lane read (u << w) | v as one
//     2w-bit field and its V channel takes the low w bits
//     (decoder.go:314-321, 492-502);
//   - the un-mix of each channel pair (matrix.go:38-49);
//   - the shift bits put back, (x << bs*8) | bits with the count clamped to 31
//     (matrix.go:129-131), at 24 and 32 bits; the << 4 at 20 bits;
//   - the MPEG -> SMPTE remap, where a slot that no element filled stays 0;
//   - the interleaved little-endian PCM, 2, 3 or 4 bytes a sample.
//
// Every layout that `finish_packed` returns (16-bit pairs in int32 words,
// four 3-byte samples in three int32 words, `pack_output`'s int16, uint8 and
// int32 rows) holds the same bytes: row b is packet b's F*C samples in stream
// order s = f*C + c, kBps bytes each.  So the kernel writes bytes, and the
// wrapper picks the tensor's dtype and shape.
//
// What bounds it on an H100: bytes.  It reads the LPC's samples (F, C*B) int32
// once, the raw reader's output once where a split needs it, and writes the
// rows once: at the 7.1 24-bit shapes (B=2048, F=4096) 268 MB and 168 MB read
// and 201 MB written, ~0.19 ms at 3.35 TB/s.
//
// Layout: the inputs are F-major (a row a frame, lanes channel-major: lane
// c*B + b) and each output row is one packet, so the kernel is a transpose.
// A block takes a tile of kTileF frames x kTileB packets, all C channels.
// Warp g takes frames [4g, 4g + 4) of the tile and lane i packet i, so each
// load of a warp is 32 adjacent int32, one 128-byte line.  A thread does the
// arithmetic of its 4 frames x C channels in registers and packs their 4C
// samples into C*kBps whole words in shared memory, one row of the tile a
// packet.  After a barrier the block writes each packet's run of the tile
// (kTileF*C*kBps contiguous bytes of its output row) with adjacent threads on
// adjacent addresses: 16-byte stores where every row starts 16-byte aligned
// (F*C*kBps a multiple of 16: the VEC instantiation), else byte by byte.
// Depth and the store width are template parameters; C, F and B are
// arguments, so one kernel serves every channel count.  The loops over
// channels are unrolled to 8 and guarded by C, so no register array is
// indexed at run time.

#include <cuda_runtime.h>

#include <cstdint>

#include "alac_int.cuh"

namespace {

using namespace alac;

constexpr int kMaxC = 8;
constexpr int kTileB = 32;                // packets of a tile: a warp's lanes
constexpr int kGroupF = 4;                // frames a thread
constexpr int kWarps = 8;                 // frame groups of a tile
constexpr int kTileF = kGroupF * kWarps;  // frames of a tile
constexpr int kThreads = 32 * kWarps;

template <int DEPTH, bool VEC>
__global__ void __launch_bounds__(kThreads) epilogue_kernel(
    const int32_t* __restrict__ mix, const int32_t* __restrict__ raw,
    const int32_t* __restrict__ bs, const int32_t* __restrict__ mixbits,
    const int32_t* __restrict__ mixres, const int32_t* __restrict__ role,
    const int32_t* __restrict__ out_chan, const int32_t* __restrict__ filled,
    uint8_t* __restrict__ out, int B, int C, int F) {
  constexpr int kBps = DEPTH == 16 ? 2 : DEPTH == 32 ? 4 : 3;
  constexpr bool kShift = DEPTH == 24 || DEPTH == 32;
  constexpr uint32_t kMask = kBps == 4 ? 0xFFFFFFFFu : (1u << (8 * kBps)) - 1u;
  // A packet's row of the tile: kWarps groups of C*kBps words, then 4 words
  // of pad, so every row starts 16-byte aligned.
  __shared__ uint4 tile4[kTileB * (kWarps * kMaxC * kBps + 4) / 4];
  uint32_t* tile = reinterpret_cast<uint32_t*>(tile4);
  const int group_words = C * kBps;
  const int stride = kWarps * group_words + 4;

  const int f_tiles = (F + kTileF - 1) / kTileF;
  const int b0 = static_cast<int>(blockIdx.x / f_tiles) * kTileB;
  const int f0 = static_cast<int>(blockIdx.x % f_tiles) * kTileF;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int b = b0 + lane;
  const int64_t L = static_cast<int64_t>(C) * B;

  if (b < B) {
    // The packet's channel fields.  src[o]: the last channel whose element
    // filled output slot o, or -1 (the twin's selects, later slots winning).
    int32_t rl[kMaxC], mr[kMaxC], mb[kMaxC], wd[kMaxC], oc[kMaxC], src[kMaxC];
    bool sh[kMaxC], fl[kMaxC], need[kMaxC];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int64_t i = static_cast<int64_t>(b) * C + c;
      const bool on = c < C;
      rl[c] = on ? __ldg(role + i) : 0;
      mr[c] = on ? __ldg(mixres + i) : 0;
      mb[c] = on ? __ldg(mixbits + i) : 0;
      const int32_t s = on ? __ldg(bs + i) : 0;
      wd[c] = wmul(s, 8);
      sh[c] = s > 0;
      oc[c] = on ? __ldg(out_chan + i) : -1;
      fl[c] = on && __ldg(filled + i) != 0;
    }
#pragma unroll
    for (int o = 0; o < kMaxC; ++o) {
      src[o] = -1;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (fl[c] && oc[c] == o) src[o] = c;
      }
    }
    // The lanes the raw reader read (`shift_reads`: bs > 0, not a V
    // channel); it wrote 0 on every other lane, so those are not loaded.
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) need[c] = kShift && c < C && sh[c] && rl[c] != 2;

    uint32_t* row = tile + lane * stride + g * group_words;
    uint64_t acc = 0;
    int nbits = 0, k = 0;
#pragma unroll
    for (int j = 0; j < kGroupF; ++j) {
      const int f = f0 + g * kGroupF + j;
      const bool in = f < F;
      const int64_t at = static_cast<int64_t>(f) * L + b;
      uint32_t x[kMaxC], r[kMaxC];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        const int64_t i = at + static_cast<int64_t>(c) * B;
        x[c] = in && c < C ? static_cast<uint32_t>(__ldg(mix + i)) : 0u;
        r[c] = in && need[c] ? static_cast<uint32_t>(__ldg(raw + i)) : 0u;
      }
      // Un-mix, channel pair by channel pair in order:
      //   left = u + v - ((mixres * v) >> mixbits); right = left - v.
#pragma unroll
      for (int c = 0; c + 1 < kMaxC; ++c) {
        if (c + 1 < C && rl[c] == 1 && mr[c] != 0) {
          const uint32_t v = x[c + 1];
          const int32_t corr = sshr32(wmul(mr[c], static_cast<int32_t>(v)), mb[c]);
          const uint32_t left = x[c] + v - static_cast<uint32_t>(corr);
          x[c] = left;
          x[c + 1] = left - v;
        }
      }
      if (kShift) {
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) {
          if (c < C && sh[c]) {
            uint32_t v = rl[c] == 1 ? ushr32(r[c], wd[c]) : r[c];
            if (c > 0 && rl[c] == 2) v = r[c - 1] & (shl32(1u, wd[c]) - 1u);
            x[c] = shl32(x[c], min(wd[c], 31)) | v;
          }
        }
      }
      if (DEPTH == 20) {
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) x[c] <<= 4;
      }
      // The SMPTE-ordered samples of the frame into the packet's byte stream.
#pragma unroll
      for (int o = 0; o < kMaxC; ++o) {
        if (o < C) {
          uint32_t y = 0;
#pragma unroll
          for (int c = 0; c < kMaxC; ++c) {
            if (src[o] == c) y = x[c];
          }
          acc |= static_cast<uint64_t>(y & kMask) << nbits;
          nbits += 8 * kBps;
          if (nbits >= 32) {
            row[k++] = static_cast<uint32_t>(acc);
            acc >>= 32;
            nbits -= 32;
          }
        }
      }
    }
  }
  __syncthreads();

  const int nb = min(kTileB, B - b0);
  const int run = min(kTileF, F - f0) * C * kBps;  // bytes of a packet's run
  const int64_t row_bytes = static_cast<int64_t>(F) * C * kBps;
  uint8_t* dst = out + b0 * row_bytes + static_cast<int64_t>(f0) * C * kBps;
  if (VEC) {
    const int q = run >> 4;
    for (int i = threadIdx.x; i < nb * q; i += kThreads) {
      const int p = i / q, k = i - p * q;
      *reinterpret_cast<uint4*>(dst + p * row_bytes + 16 * k) =
          *reinterpret_cast<const uint4*>(tile + p * stride + 4 * k);
    }
  } else {
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(tile);
    for (int i = threadIdx.x; i < nb * run; i += kThreads) {
      const int p = i / run, k = i - p * run;
      dst[p * row_bytes + k] = bytes[4 * p * stride + k];
    }
  }
}

template <int DEPTH>
int launch(const void* mix, const void* raw, const void* bs, const void* mixbits,
           const void* mixres, const void* role, const void* out_chan, const void* filled,
           void* out, int B, int C, int F, bool vec, cudaStream_t stream) {
  const int blocks = ((B + kTileB - 1) / kTileB) * ((F + kTileF - 1) / kTileF);
  if (blocks > 0) {
    const auto kernel = vec ? epilogue_kernel<DEPTH, true> : epilogue_kernel<DEPTH, false>;
    kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const int32_t*>(mix), static_cast<const int32_t*>(raw),
        static_cast<const int32_t*>(bs), static_cast<const int32_t*>(mixbits),
        static_cast<const int32_t*>(mixres), static_cast<const int32_t*>(role),
        static_cast<const int32_t*>(out_chan), static_cast<const int32_t*>(filled),
        static_cast<uint8_t*>(out), B, C, F);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mix (F, C*B) and raw (at least F rows of C*B; read at depth 24 and 32
// only) int32, lanes channel-major; the six channel fields (B, C) int32;
// out (B, F*C*bytes a sample) bytes.  vec: every row of out starts 16-byte
// aligned.  Returns the CUDA error of the launch (0: none).
extern "C" int alac_epilogue_launch(const void* mix, const void* raw, const void* bs,
                                    const void* mixbits, const void* mixres, const void* role,
                                    const void* out_chan, const void* filled, void* out, int B,
                                    int C, int F, int depth, int vec, void* stream) {
  const auto run = depth == 16   ? launch<16>
                   : depth == 20 ? launch<20>
                   : depth == 24 ? launch<24>
                   : depth == 32 ? launch<32>
                                 : nullptr;
  if (run == nullptr || C < 1 || C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  return run(mix, raw, bs, mixbits, mixres, role, out_chan, filled, out, B, C, F, vec != 0,
             static_cast<cudaStream_t>(stream));
}
