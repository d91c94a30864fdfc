// Device code shared by the walk kernels: the bit reader, the element parse
// and one pass of the adaptive Golomb-Rice walk.
//
// element_kernel.cu (one element per lane), packet_kernel.cu (every element
// of a packet per lane) and dense_entropy_kernel.cu (the walk alone, no
// parse) include this header, so the three run one parse and one walk loop.
// Everything is per thread and in registers: no shared memory, no barriers.
// Parity: decoder.go:210-265/348-460 (headers), golomb.go:112-253 (entropy),
// bitbuffer.go:28-32 (zero reads past the end).
#pragma once

#include <cstddef>
#include <cstdint>

#include "alac_int.cuh"

namespace alac {

constexpr int32_t ERR_NONE = 0;
constexpr int32_t ERR_OVERRUN = 1;
constexpr int32_t ERR_ELEMENT = 2;
constexpr int32_t ERR_HEADER = 3;
constexpr int32_t ERR_SHIFT = 4;
constexpr int32_t ERR_SAMPLES = 5;
constexpr int32_t ERR_SLOTS = 6;
constexpr int32_t ERR_WIDTH = 7;
// Metadata rows of the element kernel (ops/walk_kernel.py M_*).
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

// Predictor header + coefficients of one channel; the 32 coefficients land
// at dst[j * stride] (0 beyond num or where the lane does not decode them).
// A null dst skips the stores.
struct PredHeader {
  int32_t mode, den, pbf, num, end;
};

__device__ __forceinline__ PredHeader pred_header(
    const Bits& s, int32_t pc, bool mask, int32_t* dst, size_t stride) {
  int32_t b1 = s.rd(pc, 8), b2 = s.rd(pc + 8, 8);
  PredHeader h{b1 >> 4, b1 & 15, b2 >> 5, b2 & 31, 0};
  if (dst != nullptr) {
    for (int j = 0; j < 32; ++j) {
      int32_t c = 0;
      if (mask && j < h.num) {
        c = s.rd(pc + 16 + 16 * j, 16);
        c = c >= 32768 ? c - 65536 : c;
      }
      dst[static_cast<size_t>(j) * stride] = c;
    }
  }
  h.end = pc + 16 + 16 * h.num;
  return h;
}

// One parsed element.  Fields are the reads at the element's bit position
// whatever the tag is; the flags say what they mean.
struct Element {
  int32_t tag, err, ns, bsf, mixbits, mixres;
  int32_t p_pred, p_ent, esc_base, p_esc_end, cb_comp, esc_cb;
  bool is_sce, is_cpe, is_comp, is_escape;
  PredHeader hu, hv;
};

// Tag, element header, predictor headers and coefficients of the element at
// bitpos: same reads, error codes and precedence as the TPU kernel's parse.
// ``pa`` is false for a lane with no element this call.
__device__ __forceinline__ Element parse_element(
    const Bits& s, int32_t bitpos, bool pa, bool allow_cpe, int32_t sz, int32_t ns_in,
    int F, int depth, int32_t* coefs_u, int32_t* coefs_v, size_t coef_stride) {
  Element e;
  e.tag = s.rd(bitpos, 3);
  const int32_t p0 = bitpos + 3;
  bool is_sce = pa && (e.tag == 0 || e.tag == 3);
  bool is_cpe = pa && e.tag == 1 && allow_cpe;
  bool is_elem = is_sce || is_cpe;
  int32_t err = (pa && (e.tag == 2 || e.tag == 5)) ? ERR_ELEMENT : ERR_NONE;
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

  e.mixbits = s.rd(p, 8);
  const int32_t mixres8 = s.rd(p + 8, 8);
  e.mixres = mixres8 >= 128 ? mixres8 - 256 : mixres8;
  e.hu = pred_header(s, p + 16, is_comp, coefs_u, coef_stride);
  e.hv = pred_header(s, e.hu.end, is_cpe && is_comp, coefs_v, coef_stride);
  e.p_pred = is_cpe ? e.hv.end : e.hu.end;

  // Shift region skipped (decoder.go:289-293, 453-457); escape raw data
  // begins right after the element header.
  const int32_t nch = is_cpe ? 2 : 1;
  e.p_ent = e.p_pred + (is_comp ? bsf * 8 * nch * ns : 0);
  e.esc_base = p;
  e.p_esc_end = p + ns * esc_cb * nch;
  if (is_escape && e.p_esc_end > sz) err = ERR_OVERRUN;
  e.is_escape = is_escape && err == ERR_NONE;
  e.is_comp = is_comp && is_elem && err == ERR_NONE;
  e.is_sce = is_sce;
  e.is_cpe = is_cpe;
  e.err = err;
  e.ns = ns;
  e.bsf = bsf;
  e.cb_comp = cb_comp;
  e.esc_cb = esc_cb;
  return e;
}

// What one lane's walk reads but never changes.
struct WalkLane {
  bool raw;  // escape lane: fixed-width raw fields instead of codewords
  int32_t rstep, rawcb;  // raw stride and field width
  int32_t max_size;  // width of an escape codeword's suffix
  int32_t ns, sz, kb;
  uint32_t wb_mask;

  __device__ __forceinline__ static uint32_t mask_of(int kb) {
    return kb < 32 ? (1u << kb) - 1u : 0xFFFFFFFFu;
  }
};

// The carried state of one lane's walk.
struct Walk {
  bool act;
  int32_t off, err, count, mean, zmode, zrem;

  // A pass starts with fresh entropy state at the cursor it is given.
  __device__ __forceinline__ void start(bool on, int32_t mb) {
    act = on;
    count = 0;
    mean = mb;
    zmode = 0;
    zrem = 0;
  }
};

// One pass of the walk (golomb.go:112-253): row t of the pass goes to
// out[t * stride] for every t < F_pad, the dense emission schedule of the TPU
// kernels: a lane decodes one codeword, drains one zero of a pending run,
// reads one raw field, or idles and emits 0.
__device__ __forceinline__ void walk_pass(
    BitBuffer& buf, Walk& w, const WalkLane& ln, int32_t pbl, int32_t* out, size_t stride,
    int F_pad) {
  bool act = w.act;
  int32_t off = w.off, err = w.err, count = w.count, mean = w.mean, zmode = w.zmode,
          zrem = w.zrem;
  const int32_t ns = ln.ns, sz = ln.sz, kb = ln.kb, max_size = ln.max_size;
  for (int t = 0; t < F_pad; ++t) {
    int32_t emit = 0;
    if (act) {
      if (ln.raw) {
        emit = sshr32(buf.win32(off), 32 - ln.rawcb);
        off += ln.rstep;
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
            const int32_t mz = static_cast<int32_t>((shl32(1u, k32) - 1u) & ln.wb_mask);
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
    out[static_cast<size_t>(t) * stride] = emit;
  }
  w.act = act;
  w.off = off;
  w.err = err;
  w.count = count;
  w.mean = mean;
  w.zmode = zmode;
  w.zrem = zrem;
}

// The walk of one parsed element: the U channel into rows out[0 .. F_pad)
// and, with passes == 2, the V channel into the F_pad rows at out +
// pass_stride (zeros where the element has no V).  Rows are row_stride
// apart.  Returns the end cursor and the element's error code.
struct ElementEnd {
  int32_t off, err;
};

__device__ __forceinline__ ElementEnd walk_element(
    const Bits& s, const Element& e, int32_t sz, int kb, int pb_cfg, int mb_cfg, int passes,
    int32_t* out, size_t pass_stride, size_t row_stride, int F_pad) {
  const int32_t nch = e.is_cpe ? 2 : 1;
  // Escape lanes read raw fixed-width fields: SCE cb apart, CPE 2cb (U and
  // V interleaved).
  const WalkLane ln{e.is_escape, nch * e.esc_cb, e.esc_cb > 1 ? e.esc_cb : 1,
                    e.cb_comp, e.ns, sz, kb, WalkLane::mask_of(kb)};
  Walk w;
  w.err = e.err;
  w.off = e.is_escape ? e.esc_base : e.p_ent;
  w.start((e.is_comp || e.is_escape) && e.ns > 0, mb_cfg);
  BitBuffer buf(s, w.off);
  int32_t pbl = sshr32(pb_cfg * e.hu.pbf, 2);
  for (int pass = 0; pass < passes; ++pass) {
    if (pass == 1) {
      // V restarts at U's end cursor with fresh state and the V tuning;
      // escape lanes rewind to the V phase of the interleaved raw region.
      w.start(e.is_cpe && (e.is_comp || e.is_escape) && e.ns > 0 && w.err == ERR_NONE, mb_cfg);
      pbl = sshr32(pb_cfg * e.hv.pbf, 2);
      if (e.is_escape) w.off = e.esc_base + e.esc_cb;
    }
    walk_pass(buf, w, ln, pbl, out + pass * pass_stride, row_stride, F_pad);
  }
  return ElementEnd{w.off, w.err};
}

}  // namespace alac
