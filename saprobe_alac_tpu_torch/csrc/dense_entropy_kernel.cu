// Dense entropy kernel: the adaptive Golomb-Rice walk alone, no parse.
//
// Replaces the TPU kernel saprobe_alac_tpu/ops/walk_kernel.py `_dense_kernel`
// (entry `dense_entropy_pallas`).  One thread walks one lane from the bit
// cursor it is given, with the lane's own tuning (pb, max_size, mb) instead
// of an element header's: rows[0][t][b] for every t < F_pad, and with
// passes == 2 a second channel whose codewords follow the first in the
// stream into rows[1] (lanes of ``act2`` restart at their pass-1 end cursor
// with fresh entropy state and ``pb2``, only where pass 1 ended without an
// error).  Lanes with ns == 0 stay idle in both passes; the end cursor is
// reported for the lanes of ``act`` and the input cursor for the others.
//
// On a GPU this is the element kernel's walk loop without its prologue
// (element_walk.cuh `walk_pass`), so it is latency-bound the same way: one
// dependent chain of integer operations per decoded row and thread.

#include <cuda_runtime.h>

#include <cstdint>

#include "element_walk.cuh"

namespace {

using namespace alac;


__global__ void __launch_bounds__(kThreads) dense_entropy_kernel(
    const int32_t* __restrict__ words, int W, const int32_t* __restrict__ bitpos_in,
    const int32_t* __restrict__ act_in, const int32_t* __restrict__ pb,
    const int32_t* __restrict__ max_size, const int32_t* __restrict__ ns_arr,
    const int32_t* __restrict__ size_bits, const int32_t* __restrict__ mb,
    const int32_t* __restrict__ act2_in, const int32_t* __restrict__ pb2,
    int32_t* __restrict__ rows, int32_t* __restrict__ bitpos_out,
    int32_t* __restrict__ err_out, int B, int F_pad, int passes, int kb) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Bits s{words + static_cast<size_t>(b) * W, W};
  const int32_t bitpos = bitpos_in[b];
  const int32_t ns = ns_arr[b];
  const bool act0 = act_in[b] != 0;
  const WalkLane ln{false, 0, 1, max_size[b], ns, size_bits[b], kb, WalkLane::mask_of(kb)};
  Walk w;
  w.err = ERR_NONE;
  w.off = bitpos;
  w.start(act0 && ns > 0, mb[b]);
  BitStream buf(s);
  int32_t pbl = pb[b];
  for (int pass = 0; pass < passes; ++pass) {
    if (pass == 1) {
      w.start(act2_in[b] != 0 && ns > 0 && w.err == ERR_NONE, mb[b]);
      pbl = pb2[b];
    }
    walk_pass(buf, w, ln, pbl, rows + static_cast<size_t>(pass) * F_pad * B + b, B, F_pad);
  }
  bitpos_out[b] = act0 ? w.off : bitpos;
  err_out[b] = w.err;
}

}  // namespace

extern "C" int alac_dense_entropy_launch(
    const void* words, int W, const void* bitpos, const void* act, const void* pb,
    const void* max_size, const void* ns, const void* size_bits, const void* mb,
    const void* act2, const void* pb2, void* rows, void* bitpos_out, void* err, int B,
    int F_pad, int passes, int kb, void* stream) {
  if (B > 0) {
    dense_entropy_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), W, static_cast<const int32_t*>(bitpos),
        static_cast<const int32_t*>(act), static_cast<const int32_t*>(pb),
        static_cast<const int32_t*>(max_size), static_cast<const int32_t*>(ns),
        static_cast<const int32_t*>(size_bits), static_cast<const int32_t*>(mb),
        static_cast<const int32_t*>(act2), static_cast<const int32_t*>(pb2),
        static_cast<int32_t*>(rows), static_cast<int32_t*>(bitpos_out),
        static_cast<int32_t*>(err), B, F_pad, passes, kb);
  }
  return static_cast<int>(cudaGetLastError());
}
