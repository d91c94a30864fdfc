// Element kernel: SCE/CPE parse + two-pass adaptive Golomb-Rice walk.
//
// Replaces the TPU kernel saprobe_alac_tpu/ops/walk_kernel.py
// `_element_kernel` (entry `dense_element_pallas`).  One thread decodes one
// packet: it parses the 3-bit tag, the element header, the predictor headers
// and the int16 coefficients (walk_kernel.py:829-960, same reads, error codes
// and precedence), then walks the U channel and then the V channel
// (golomb.go:112-253), writing rows[p][t][b] for every t < F_pad — the dense
// emission schedule of the TPU kernel, zeros where a lane has nothing to
// emit — so the LPC kernel never reads an unwritten row.
//
// What bounds it on an H100: the walk is bit-serial within a packet (each
// codeword's length depends on its value), so the kernel is latency-bound:
// B=2048 packets are 2048 threads, 16 blocks of 128, one warp per scheduler
// on 16 SMs, each thread running a dependent chain of integer ops per
// sample.  Measured (H100 80GB HBM3, 700 W, F=4096 stereo): about 3.9 ms at
// B=256 and at B=2048 alike, some 800 cycles per decoded row.  Memory
// traffic is small (the packet bits, and one int32 row write per sample,
// coalesced across the warp because at step t every thread writes row t).
// The design keeps all state in registers and drops the TPU's workarounds
// for a vector unit without per-lane gathers: no one-hot window fetch, no L1
// superblocks, no staging rings.  Each thread reads its own row of the
// (B, W) row-major word array through a three-word register bit buffer, so
// a decoded row costs about one load per 32 bits consumed (this took 6% off
// direct two-word reads: the loads were not the bound).

#include <cuda_runtime.h>

#include <cstdint>

#include "element_walk.cuh"

namespace {

using namespace alac;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) element_kernel(
    const int32_t* __restrict__ words, int W, const int32_t* __restrict__ bitpos_in,
    const int32_t* __restrict__ pact, const int32_t* __restrict__ size_bits,
    const int32_t* __restrict__ ns_in_arr, const int32_t* __restrict__ allow_cpe,
    int32_t* __restrict__ rows, int32_t* __restrict__ bitpos_out,
    int32_t* __restrict__ err_out, int32_t* __restrict__ meta, int B, int F,
    int F_pad, int passes, int kb, int depth, int pb_cfg, int mb_cfg) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const Bits s{words + static_cast<size_t>(b) * W, W};
  const int32_t bitpos = bitpos_in[b];
  const int32_t sz = size_bits[b];

  // Parse (element_walk.cuh); the coefficients land in their meta rows.
  const Element e = parse_element(
      s, bitpos, pact[b] != 0, allow_cpe[b] != 0, sz, ns_in_arr[b], F, depth,
      meta + static_cast<size_t>(M_COEFS_U) * B + b, meta + static_cast<size_t>(M_COEFS_V) * B + b,
      B);
  const int32_t vals[18] = {
      e.tag, e.ns, e.bsf, e.is_escape, e.is_comp, e.mixbits, e.mixres, e.hu.mode, e.hu.den,
      e.hu.num, e.hv.mode, e.hv.den, e.hv.num, e.p_pred, e.esc_base, e.p_esc_end, e.is_sce,
      e.is_cpe};
#pragma unroll
  for (int r = 0; r < 18; ++r) meta[static_cast<size_t>(r) * B + b] = vals[r];

  // Entropy walk: U into rows[0], then V into rows[1].
  const ElementEnd end = walk_element(
      s, e, sz, kb, pb_cfg, mb_cfg, passes, rows + b, static_cast<size_t>(F_pad) * B, B, F_pad);
  bitpos_out[b] = e.is_comp ? end.off : bitpos;
  err_out[b] = end.err;
}

}  // namespace

extern "C" int alac_element_launch(
    const void* words, int W, const void* bitpos, const void* pact, const void* size_bits,
    const void* ns, const void* allow_cpe, void* rows, void* bitpos_out, void* err,
    void* meta, int B, int F, int F_pad, int passes, int kb, int depth, int pb_cfg,
    int mb_cfg, void* stream) {
  if (B > 0) {
    element_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), W, static_cast<const int32_t*>(bitpos),
        static_cast<const int32_t*>(pact), static_cast<const int32_t*>(size_bits),
        static_cast<const int32_t*>(ns), static_cast<const int32_t*>(allow_cpe),
        static_cast<int32_t*>(rows), static_cast<int32_t*>(bitpos_out),
        static_cast<int32_t*>(err), static_cast<int32_t*>(meta), B, F, F_pad, passes, kb,
        depth, pb_cfg, mb_cfg);
  }
  return static_cast<int>(cudaGetLastError());
}
