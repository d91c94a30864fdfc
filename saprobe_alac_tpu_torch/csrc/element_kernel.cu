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

#include "alac_int.cuh"

namespace {

using namespace alac;

constexpr int kThreads = 128;
constexpr int32_t ERR_NONE = 0;
constexpr int32_t ERR_OVERRUN = 1;
constexpr int32_t ERR_ELEMENT = 2;
constexpr int32_t ERR_HEADER = 3;
constexpr int32_t ERR_SHIFT = 4;
constexpr int32_t ERR_SAMPLES = 5;
constexpr int32_t ERR_WIDTH = 7;
// Metadata rows (walk_kernel.py:118-126).
enum : int {
  M_TAG, M_NS, M_BSF, M_ESC, M_COMP, M_MIXBITS, M_MIXRES,
  M_MODE_U, M_DEN_U, M_NUM_U, M_MODE_V, M_DEN_V, M_NUM_V,
  M_SHIFT_BASE, M_ESC_BASE, M_ESC_END, M_SCE, M_CPE,
  M_COEFS_U = 18, M_COEFS_V = 50,
};

// One packet's big-endian words; words outside [0, W) read as zero
// (bitbuffer.go:28-32).
struct Bits {
  const int32_t* row;
  int32_t W;

  __device__ __forceinline__ uint32_t word(int32_t i) const {
    return (i >= 0 && i < W) ? static_cast<uint32_t>(__ldg(row + i)) : 0u;
  }
  // The 32 stream bits starting at bit position pos.
  __device__ __forceinline__ int32_t win32(int32_t pos) const {
    int32_t wi = pos >> 5;
    int32_t r = pos & 31;
    uint32_t a = word(wi), b = word(wi + 1);
    return static_cast<int32_t>((a << r) | ((b >> 1) >> (31 - r)));
  }
  // Right-aligned n-bit read (1 <= n <= 32).
  __device__ __forceinline__ int32_t rd(int32_t pos, int n) const {
    return static_cast<int32_t>(ushr32(static_cast<uint32_t>(win32(pos)), 32 - n));
  }
};

// The walk's bit buffer: three consecutive words of the packet held in
// registers.  The walk's reads move forward, so a read one word further on
// costs one load and a read in the same word costs none; any other jump
// (the V pass rewind of escape lanes, long raw strides) reloads all three.
struct BitBuffer {
  const Bits& s;
  int32_t base;  // word index of w0
  uint32_t w0, w1, w2;

  __device__ __forceinline__ BitBuffer(const Bits& bits, int32_t pos) : s(bits) { reload(pos >> 5); }
  __device__ __forceinline__ void reload(int32_t wi) {
    base = wi;
    w0 = s.word(wi);
    w1 = s.word(wi + 1);
    w2 = s.word(wi + 2);
  }
  // The 32 stream bits starting at bit position pos.
  __device__ __forceinline__ int32_t win32(int32_t pos) {
    const int32_t wi = pos >> 5;
    const int32_t d = wsub(wi, base);
    if (d == 1) {
      w0 = w1;
      w1 = w2;
      w2 = s.word(wi + 2);
      base = wi;
    } else if (d != 0) {
      reload(wi);
    }
    const int32_t r = pos & 31;
    return static_cast<int32_t>((w0 << r) | ((w1 >> 1) >> (31 - r)));
  }
};

// Predictor header + coefficients of one channel; coefficients land in
// their meta rows (0 beyond num or where the lane does not decode them).
struct PredHeader {
  int32_t mode, den, pbf, num, end;
};

__device__ __forceinline__ PredHeader pred_header(
    const Bits& s, int32_t pc, bool mask, int32_t* meta, int row0, int B, int b) {
  int32_t b1 = s.rd(pc, 8), b2 = s.rd(pc + 8, 8);
  PredHeader h{b1 >> 4, b1 & 15, b2 >> 5, b2 & 31, 0};
  for (int j = 0; j < 32; ++j) {
    int32_t c = 0;
    if (mask && j < h.num) {
      c = s.rd(pc + 16 + 16 * j, 16);
      c = c >= 32768 ? c - 65536 : c;
    }
    meta[static_cast<size_t>(row0 + j) * B + b] = c;
  }
  h.end = pc + 16 + 16 * h.num;
  return h;
}

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
  const int32_t ns_in = ns_in_arr[b];
  const bool pa = pact[b] != 0;

  // ---- parse (walk_kernel.py:829-960) ----
  const int32_t tag = s.rd(bitpos, 3);
  const int32_t p0 = bitpos + 3;
  bool is_sce = pa && (tag == 0 || tag == 3);
  bool is_cpe = pa && tag == 1 && allow_cpe[b] != 0;
  bool is_elem = is_sce || is_cpe;
  int32_t err = (pa && (tag == 2 || tag == 5)) ? ERR_ELEMENT : ERR_NONE;
  auto keep = [&]() {
    is_elem = is_elem && err == ERR_NONE;
    is_sce = is_sce && is_elem;
    is_cpe = is_cpe && is_elem;
  };

  // 4-bit instance tag skipped; 12 unused bits must be zero; then the
  // partial / bytesShifted / escape flags (decoder.go:210-235, 348-375).
  const int32_t unused = s.rd(p0 + 4, 12);
  const int32_t hdr4 = s.rd(p0 + 16, 4);
  const int32_t partial = hdr4 >> 3, bsf = (hdr4 >> 1) & 3, escf = hdr4 & 1;
  if (is_elem && unused != 0) err = ERR_HEADER;
  if (is_elem && bsf == 3) err = ERR_SHIFT;
  keep();

  int32_t p = p0 + 20;
  const int32_t ns_new = (is_elem && partial == 1) ? s.rd(p, 32) : ns_in;
  if (is_elem && (ns_new > F || ns_new < 0)) err = ERR_SAMPLES;
  keep();
  if (is_elem && partial == 1) p += 32;
  const int32_t ns = is_elem ? ns_new : ns_in;

  // chan_bits (decoder.go:230, 371); escape resets (:326, 388).  Widths
  // outside [1, 32] go to the exact host fallback (ERR_WIDTH).
  const int32_t cb_comp = depth - bsf * 8 + (is_cpe ? 1 : 0);
  const int32_t esc_cb = is_cpe ? depth : depth - bsf * 8;
  const bool bad_width =
      (escf == 0 && (cb_comp > 32 || cb_comp < 1)) || (escf == 1 && esc_cb < 1);
  if (is_elem && bad_width) err = ERR_WIDTH;
  keep();
  bool is_comp = is_elem && escf == 0;
  bool is_escape = is_elem && escf == 1;

  const int32_t mixbits = s.rd(p, 8);
  const int32_t mixres8 = s.rd(p + 8, 8);
  const int32_t mixres = mixres8 >= 128 ? mixres8 - 256 : mixres8;
  const PredHeader hu = pred_header(s, p + 16, is_comp, meta, M_COEFS_U, B, b);
  const PredHeader hv = pred_header(s, hu.end, is_cpe && is_comp, meta, M_COEFS_V, B, b);
  const int32_t p_pred = is_cpe ? hv.end : hu.end;

  // Shift region skipped (decoder.go:289-293, 453-457); escape raw data
  // begins right after the element header.
  const int32_t nch = is_cpe ? 2 : 1;
  const int32_t p_ent = p_pred + (is_comp ? bsf * 8 * nch * ns : 0);
  const int32_t esc_base = p;
  const int32_t p_esc_end = p + ns * esc_cb * nch;
  if (is_escape && p_esc_end > sz) err = ERR_OVERRUN;
  is_escape = is_escape && err == ERR_NONE;
  is_comp = is_comp && is_elem && err == ERR_NONE;

  const int32_t vals[18] = {
      tag, ns, bsf, is_escape, is_comp, mixbits, mixres, hu.mode, hu.den, hu.num,
      hv.mode, hv.den, hv.num, p_pred, esc_base, p_esc_end, is_sce, is_cpe};
#pragma unroll
  for (int r = 0; r < 18; ++r) meta[static_cast<size_t>(r) * B + b] = vals[r];

  // ---- entropy walk: U, then V (walk_kernel.py:284-626) ----
  const bool raw = is_escape;  // escape lanes read raw fixed-width fields
  const int32_t rstep = nch * esc_cb;  // SCE cb, CPE 2cb (U/V interleaved)
  const int32_t rawcb = esc_cb > 1 ? esc_cb : 1;
  const int32_t raw_vpos = esc_base + esc_cb;
  const int32_t max_size = cb_comp;
  const int32_t pb_u = sshr32(pb_cfg * hu.pbf, 2);
  const int32_t pb_v = sshr32(pb_cfg * hv.pbf, 2);
  const bool act2v = is_cpe && (is_comp || is_escape) && ns > 0;
  const uint32_t wb_mask = kb < 32 ? (1u << kb) - 1u : 0xFFFFFFFFu;

  bool act = (is_comp || raw) && ns > 0;
  int32_t off = raw ? esc_base : p_ent;
  BitBuffer buf(s, off);
  int32_t count = 0, mean = mb_cfg, zmode = 0, zrem = 0, pbl = pb_u;
  for (int pass = 0; pass < passes; ++pass) {
    if (pass == 1) {
      // V restarts at U's end cursor with fresh state and the V tuning;
      // escape lanes rewind to the V phase of the interleaved raw region.
      act = act2v && err == ERR_NONE;
      count = 0;
      mean = mb_cfg;
      zmode = 0;
      zrem = 0;
      pbl = pb_v;
      if (raw) off = raw_vpos;
    }
    int32_t* out = rows + static_cast<size_t>(pass) * F_pad * B + b;
    for (int t = 0; t < F_pad; ++t) {
      int32_t emit = 0;
      if (act) {
        if (raw) {
          emit = sshr32(buf.win32(off), 32 - rawcb);
          off += rstep;
          ++count;
        } else if (zrem > 0) {  // drain one zero of a pending run
          --zrem;
          ++count;
        } else if (zrem == 0) {
          if (off >= sz || off < 0) {  // overrun guard (golomb.go:168-170)
            err = ERR_OVERRUN;
            act = false;
          } else {
            const int32_t k = min(lg3a(static_cast<int32_t>(static_cast<uint32_t>(mean) >> 9)), kb);
            const int32_t m = static_cast<int32_t>(shl32(1u, k) - 1u);
            const int32_t win = buf.win32(off);
            const int32_t pre = clz32(~win);
            int32_t value, nbits;
            if (pre >= 9) {  // escape: raw max_size bits
              value = static_cast<int32_t>(ushr32(
                  static_cast<uint32_t>(buf.win32(off + 9)), 32 - (max_size > 1 ? max_size : 1)));
              nbits = 9 + max_size;
            } else if (k != 1) {
              const int32_t v = static_cast<int32_t>(
                  ushr32(shl32(static_cast<uint32_t>(win), pre + 1), 32 - k));
              const bool vbig = v >= 2;
              value = vbig ? wadd(wmul(pre, m), v - 1) : wmul(pre, m);
              nbits = pre + 1 + (vbig ? k : k - 1);
            } else {
              value = pre;
              nbits = pre + 1;
            }
            // Signed mapping (golomb.go:206-212), wrapping 32-bit.
            const int32_t nd = wadd(value, zmode);
            emit = wmul(static_cast<int32_t>(static_cast<uint32_t>(wadd(nd, 1)) >> 1),
                        1 - 2 * (nd & 1));
            ++count;
            off = wadd(off, nbits);
            // Adaptive mean (golomb.go:215-218), uint32 wrap.
            const uint32_t pu = static_cast<uint32_t>(pbl);
            uint32_t mean_n = pu * static_cast<uint32_t>(nd) + static_cast<uint32_t>(mean) -
                              ((pu * static_cast<uint32_t>(mean)) >> 9);
            if (static_cast<uint32_t>(value) > 0xFFFFu) mean_n = 0xFFFFu;
            mean = static_cast<int32_t>(mean_n);
            zmode = 0;
            // Zero-run mode (golomb.go:223-246): (mean << 2) < 512 unsigned.
            if (shl32(static_cast<uint32_t>(mean), 2) < 512u && count < ns) {
              int32_t k32 = clz32(mean) - 24 +
                            static_cast<int32_t>((static_cast<uint32_t>(mean) + 16u) >> 6);
              if (k32 < 0) k32 = 0;
              const int32_t mz = static_cast<int32_t>((shl32(1u, k32) - 1u) & wb_mask);
              const int32_t zwin = buf.win32(off);
              const int32_t zpre = clz32(~zwin);
              int32_t zrun, zbits;
              if (zpre >= 9) {
                zrun = static_cast<int32_t>(ushr32(shl32(static_cast<uint32_t>(zwin), 9), 16));
                zbits = 25;
              } else {
                const int32_t zv = k32 == 0 ? 0
                    : static_cast<int32_t>(ushr32(shl32(static_cast<uint32_t>(zwin), zpre + 1), 32 - k32));
                const bool zvbig = zv >= 2;
                zrun = zvbig ? wadd(wmul(zpre, mz), zv - 1) : wmul(zpre, mz);
                zbits = zpre + 1 + (zvbig ? k32 : k32 - 1);
              }
              if (wadd(count, zrun) > ns) {
                err = ERR_SAMPLES;
                act = false;
              } else {
                zrem = zrun;
                off = wadd(off, zbits);
                zmode = zrun >= 65535 ? 0 : 1;
                mean = 0;
              }
            }
          }
        }
        act = act && count < ns && err == ERR_NONE;
      }
      out[static_cast<size_t>(t) * B] = emit;
    }
  }
  bitpos_out[b] = is_comp ? off : bitpos;
  err_out[b] = err;
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
