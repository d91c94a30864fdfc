// Packet kernel: every element of a packet in one launch.
//
// The multi-element entry of the element walk.  The TPU package walks a
// packet of several elements (SCE CPE CPE CPE SCE for 7.1 surround, SCE+SCE
// stereo, DSE and FIL elements before or between them) with a slot loop
// around saprobe_alac_tpu/ops/walk_kernel.py `_element_kernel`: up to C + 4
// kernel calls a batch, each followed by one-hot commits of the element's
// metadata and a select that merges its rows into an (F, C, B) stack
// (saprobe_alac_tpu/ops/walk.py, `slot_body_dense` and the loop after it).
// A GPU thread indexes its own packet, so here one thread runs that loop for
// one packet: it parses the element at its cursor, walks it straight into
// plane ``chan`` (and ``chan + 1`` for the V of a pair) of the (C, F_pad, B)
// rows the LPC kernel reads in place, stores the channel's metadata at
// [b][chan], skips DSE and FIL elements, and stops at END, when every
// channel is filled, at an error, or when the slot budget of C + 4 elements
// is spent (ERR_SLOTS).  Planes no element reached are zeroed, so every row
// of every plane is written.
//
// Same contract as the slot loop, field for field (ops/walk.py
// `walk_batch`, the decode path's walk for every C = 1..8, holds it to the
// TPU package in the tests).  It is latency-bound: a dependent chain per
// decoded row (element_walk.cuh `walk_pass`), one thread per packet, so a
// C-channel packet takes about C/2 times a stereo packet's time.

#include <cuda_runtime.h>

#include <cstdint>

#include "element_walk.cuh"

namespace {

using namespace alac;

constexpr int kExtraSlots = 4;  // elements beyond the channel-filling ones
// Planes of the per-channel metadata output (14, B, C), in the order of
// ops/walk.py WalkResult.
enum : int {
  K_ORDER, K_MODE, K_DEN, K_CB, K_BS, K_ESC, K_ESC_BASE, K_ESC_CB, K_SHIFT_BASE,
  K_MIXBITS, K_MIXRES, K_ROLE, K_OUT_CHAN, K_FILLED, K_FIELDS,
};

__global__ void __launch_bounds__(kThreads) packet_kernel(
    const int32_t* __restrict__ words, int W, const int32_t* __restrict__ size_bits,
    const int32_t* __restrict__ offsets, int32_t* __restrict__ rows,
    int32_t* __restrict__ err_out, int32_t* __restrict__ ns_out, int32_t* __restrict__ chan_meta,
    int32_t* __restrict__ coefs, int B, int C, int F, int F_pad, int kb, int depth, int pb_cfg,
    int mb_cfg) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Bits s{words + static_cast<size_t>(b) * W, W};
  const int32_t sz = size_bits[b];
  const size_t plane = static_cast<size_t>(F_pad) * B;
  const size_t field = static_cast<size_t>(B) * C;
  int32_t* const my_meta = chan_meta + static_cast<size_t>(b) * C;
  int32_t* const my_coefs = coefs + static_cast<size_t>(b) * C * 32;
  for (int f = 0; f < K_FIELDS; ++f)
    for (int c = 0; c < C; ++c) my_meta[f * field + c] = 0;
  for (int i = 0; i < C * 32; ++i) my_coefs[i] = 0;

  int32_t bitpos = 0, chan = 0, err = ERR_NONE, ns = F;
  bool done = false;
  for (int slot = 0; slot < C + kExtraSlots && !done && err == ERR_NONE; ++slot) {
    // Past-end check before the tag read (decoder.go:143-145).
    if (sshr32(bitpos, 3) >= sshr32(sz, 3)) {
      err = ERR_OVERRUN;
      break;
    }
    const bool allow_cpe = chan + 2 <= C;
    const Element e = parse_element(
        s, bitpos, true, allow_cpe, sz, ns, F, depth, my_coefs + chan * 32,
        chan + 1 < C ? my_coefs + (chan + 1) * 32 : nullptr, 1);
    const bool is_elem = e.is_sce || e.is_cpe;
    const int32_t p0 = bitpos + 3;
    err = e.err;
    if (is_elem) {
      // A pair walks U into plane chan and V into plane chan + 1.
      const ElementEnd end = walk_element(
          s, e, sz, kb, pb_cfg, mb_cfg, e.is_cpe ? 2 : 1, rows + chan * plane + b, plane, B,
          F_pad);
      err = end.err;
      if (e.is_comp) bitpos = end.off;
      if (e.is_escape) bitpos = e.p_esc_end;
      ns = e.ns;
      const bool pair_comp = e.is_cpe && e.is_comp;
      const int32_t out_u = offsets[min(max(chan, 0), C - 1)];
      for (int v = 0; v < (e.is_cpe ? 2 : 1); ++v) {
        int32_t* m = my_meta + chan + v;
        // Field by field: a reference to either header would put both in
        // local memory.
        m[K_ORDER * field] = e.is_comp ? (v ? e.hv.num : e.hu.num) : 0;
        m[K_MODE * field] = e.is_comp ? (v ? e.hv.mode : e.hu.mode) : 0;
        m[K_DEN * field] = e.is_comp ? (v ? e.hv.den : e.hu.den) : 0;
        m[K_CB * field] = e.is_comp ? e.cb_comp : e.esc_cb;
        m[K_BS * field] = e.is_comp ? e.bsf : 0;
        m[K_ESC * field] = e.is_escape;
        m[K_ESC_BASE * field] = e.esc_base;
        m[K_ESC_CB * field] = e.esc_cb;
        m[K_SHIFT_BASE * field] = e.p_pred;
        m[K_MIXBITS * field] = pair_comp ? e.mixbits : 0;
        m[K_MIXRES * field] = pair_comp ? e.mixres : 0;
        m[K_ROLE * field] = v ? 2 : (e.is_cpe ? 1 : 0);
        m[K_OUT_CHAN * field] = out_u + v;
        m[K_FILLED * field] = 1;
      }
    } else if (e.tag == 4) {  // DSE (decoder.go:554-574)
      const int32_t align = s.rd(p0 + 4, 1), cnt = s.rd(p0 + 5, 8);
      const bool has2 = cnt == 255;
      int32_t p = p0 + 13 + (has2 ? 8 : 0);
      if (align == 1) p = (p + 7) & ~7;
      p += (cnt + (has2 ? s.rd(p0 + 13, 8) : 0)) * 8;
      if (sshr32(p, 3) >= sshr32(sz, 3)) err = ERR_OVERRUN;
      else bitpos = p;
    } else if (e.tag == 6) {  // FIL (decoder.go:538-551)
      const int32_t cnt = s.rd(p0, 4);
      const bool has2 = cnt == 15;
      const int32_t p = p0 + 4 + (has2 ? 8 : 0) + (cnt + (has2 ? s.rd(p0 + 4, 8) - 1 : 0)) * 8;
      if (sshr32(p, 3) >= sshr32(sz, 3)) err = ERR_OVERRUN;
      else bitpos = p;
    }
    // A pair tag with one channel left ends the packet without an error,
    // as END does; so does the element that fills the last channel.
    chan += e.is_sce ? 1 : (e.is_cpe ? 2 : 0);
    done = e.tag == 7 || (e.tag == 1 && !allow_cpe) || chan >= C;
  }
  // A lane the budget left unfinished: past the end, on END, or out of slots.
  if (!done && err == ERR_NONE) {
    if (sshr32(bitpos, 3) >= sshr32(sz, 3)) err = ERR_OVERRUN;
    else if (s.rd(bitpos, 3) != 7) err = ERR_SLOTS;
  }
  for (int c = chan; c < C; ++c)
    for (int t = 0; t < F_pad; ++t) rows[c * plane + static_cast<size_t>(t) * B + b] = 0;
  err_out[b] = err;
  ns_out[b] = ns;
}

}  // namespace

extern "C" int alac_packet_launch(
    const void* words, int W, const void* size_bits, const void* offsets, void* rows, void* err,
    void* ns, void* chan_meta, void* coefs, int B, int C, int F, int F_pad, int kb, int depth,
    int pb_cfg, int mb_cfg, void* stream) {
  if (B > 0) {
    packet_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), W, static_cast<const int32_t*>(size_bits),
        static_cast<const int32_t*>(offsets), static_cast<int32_t*>(rows),
        static_cast<int32_t*>(err), static_cast<int32_t*>(ns), static_cast<int32_t*>(chan_meta),
        static_cast<int32_t*>(coefs), B, C, F, F_pad, kb, depth, pb_cfg, mb_cfg);
  }
  return static_cast<int>(cudaGetLastError());
}
