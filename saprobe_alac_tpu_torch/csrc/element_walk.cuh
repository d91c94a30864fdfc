// Device code shared by the walk kernels: the bit reader, the element parse
// and one pass of the adaptive Golomb-Rice walk.
//
// element_kernel.cu (one element per lane), packet_kernel.cu (every element
// of a packet per lane) and dense_entropy_kernel.cu (the walk alone, no
// parse) include this header, so the three run one parse and one walk loop.
// Everything is per thread and in registers: no shared memory, no barriers,
// no warp shuffles, so tests/test_torch_csrc_host.py can run a block's
// threads one after another on the host.
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

// Threads a block of the walk kernels, one thread a lane: at B=2048 blocks
// of 32 put the batch on 64 SMs, one warp to an SM.  On the H100 blocks of
// 32, 64 and 128 ran within 6% of each other and the fastest changed from
// run to run (PERF.md); 32 spreads the batch widest.
constexpr int kThreads = 32;

// One packet's big-endian words; words outside [0, W) read as zero
// (bitbuffer.go:28-32).
struct Bits {
  const int32_t* row;
  int32_t W;

  __device__ __forceinline__ uint32_t word(int32_t i) const {
    return static_cast<uint32_t>(i) < static_cast<uint32_t>(W) ? static_cast<uint32_t>(__ldg(row + i))
                                                               : 0u;
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

// Go's clamped uint32 shifts as one funnel shift each.  The clamping forms
// __funnelshift_lc / __funnelshift_rc shift by min(count, 32) with an
// unsigned count, so a count of 32 or more, or a negative one (a huge
// unsigned), gives 0: exactly shl32 / ushr32 of alac_int.cuh, in one SHF
// instead of a compare, a shift and a select.
__device__ __forceinline__ uint32_t shl32f(uint32_t x, int32_t n) {
  return __funnelshift_lc(0u, x, static_cast<uint32_t>(n));
}
__device__ __forceinline__ uint32_t ushr32f(uint32_t x, int32_t n) {
  return __funnelshift_rc(x, 0u, static_cast<uint32_t>(n));
}

// The index of the highest set bit of x (x > 0): floor(log2(x)), one
// instruction on the card.
__device__ __forceinline__ int32_t msb(uint32_t x) {
#ifdef __CUDA_ARCH__
  int32_t r;
  asm("bfind.u32 %0, %1;" : "=r"(r) : "r"(x));
  return r;
#else
  return 31 - __clz(static_cast<int32_t>(x));
#endif
}

// Rows a walk pass decodes before it stores them (walk_pass): on the H100
// pairs ran a little faster than single rows, groups of 4 and 8 no faster.
constexpr int kRowGroup = 2;
// Words ahead of the cursor the stream prefetches (BitStream::prefetch): 16,
// 32 and 64 ran alike on the H100, 128 a little slower.
constexpr int kPrefetchWords = 32;

// The walk's bit stream: the cursor at bit r of w0, the next two words in
// w1 and w2, and the word after them, w3, loaded one row ahead.  A row's
// window is one funnel shift of (w0, w1).  A step moves r and, where the
// cursor crosses into w1, shifts the words down by selects, not a branch:
// at B=2048 each thread walks its own packet and some lane of a warp
// crosses a word on nearly every row, so a branch would run on every row
// for the whole warp.  Every step loads the word at ``nxt`` (zero outside
// the row, bitbuffer.go:28-32), which the next step reads, and prefetches
// the line kPrefetchWords words on (some 100 rows of music) into L1, so the
// load hits L1 and the chain never waits on L2 or memory (on the H100 the
// largest single step of the redesign; a queue of 16-byte loads held in
// registers cost more instructions a row than it saved).  A jump the steps
// do not cover (a pass start,
// a long zero-run code, an escape suffix of unusual width) reloads the
// words at the new cursor.
struct BitStream {
  Bits s;
  int32_t nxt;  // word index of w3
  int32_t r;  // bit of w0 at the cursor, 0..31
  uint32_t w0, w1, w2, w3;
  int32_t pos;  // the stream's cursor, kept at seeks and pass ends
  bool ready;

  __device__ __forceinline__ explicit BitStream(const Bits& bits)
      : s(bits), nxt(0), r(0), w0(0), w1(0), w2(0), w3(0), pos(0), ready(false) {}

  // The stream at bit position p (any int).
  __device__ void seek(int32_t p) {
    const int32_t base = p >> 5;
    r = p & 31;
    w0 = s.word(base);
    w1 = s.word(base + 1);
    w2 = s.word(base + 2);
    nxt = base + 3;
    w3 = s.word(nxt);
    pos = p;
    ready = true;
  }
  // The 32 stream bits at the cursor: (w0:w1) << r, high word.
  __device__ __forceinline__ uint32_t window() const { return __funnelshift_l(w1, w0, r); }
  // Move the cursor n bits on, 0 <= n <= 32: r + n < 64, so at most one
  // crossing.
  __device__ __forceinline__ void step(int32_t n) {
    r += n;
    const bool c = r >= 32;
    r = c ? r - 32 : r;
    w0 = c ? w1 : w0;
    w1 = c ? w2 : w1;
    w2 = c ? w3 : w2;
    nxt += c ? 1 : 0;
    w3 = s.word(nxt);
    prefetch(nxt + kPrefetchWords);
  }
  // Ask L1 for the line holding word i (clamped into the row) ahead of its
  // load: the load of w3 above is a row ahead only, and the first touch of
  // each 32-byte sector of a packet would otherwise stall the chain on L2.
  __device__ __forceinline__ void prefetch(int32_t i) const {
#ifdef __CUDA_ARCH__
    if (s.W > 0) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(s.row + min(max(i, 0), s.W - 1)));
    }
#endif
  }
  // Move the cursor d bits on, to position ``to``: steps for 0 <= d <= 64,
  // a reload for any other jump.
  __device__ __forceinline__ void advance(int32_t d, int32_t to) {
    if (d >= 0 && d <= 64) {
      const int32_t a = d < 32 ? d : 32;
      step(a);
      step(d - a);
    } else {
      seek(to);
    }
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

// A raw (escape) lane's pass: field t sits at off + t * rstep, so the rows
// carry no state from one to the next and their loads overlap.  Row t <
// n goes to out[t * stride], where n is what the codeword loop's schedule
// gives: every remaining field (ns - count of them), at least the row on
// which the lane was active, at most F_pad.
__device__ __forceinline__ void raw_pass(
    const Bits& s, Walk& w, const WalkLane& ln, int32_t* out, size_t stride, int F_pad) {
  int32_t n = 0;
  if (w.act) {
    n = w.err == ERR_NONE ? wsub(ln.ns, w.count) : 1;
    n = min(max(n, 1), F_pad);
  }
  const int32_t sh = 32 - ln.rawcb;  // rawcb is 1..32 (esc_cb clamped to 1, depth <= 32)
#pragma unroll 4
  for (int t = 0; t < F_pad; ++t) {
    const int32_t p = wadd(w.off, wmul(t, ln.rstep));
    out[static_cast<size_t>(t) * stride] = t < n ? (s.win32(p) >> sh) : 0;
  }
  w.off = wadd(w.off, wmul(n, ln.rstep));
  w.count = wadd(w.count, n);
  w.act = w.act && w.count < ln.ns && w.err == ERR_NONE;
}

// A codeword's value, decoded: the signed mapping (golomb.go:206-212) and
// the adaptive mean (:215-218), both wrapping 32-bit, then the zero-run
// entry (:223-246) where the new mean is small.  Returns the row's residual.
__device__ __forceinline__ int32_t finish_codeword(
    BitStream& buf, Walk& w, const WalkLane& ln, uint32_t pu, int32_t value) {
  const int32_t nd = wadd(value, w.zmode);
  const int32_t emit = wmul(static_cast<int32_t>(static_cast<uint32_t>(wadd(nd, 1)) >> 1),
                            1 - 2 * (nd & 1));
  ++w.count;
  uint32_t mean_n = pu * static_cast<uint32_t>(nd) + static_cast<uint32_t>(w.mean) -
                    ((pu * static_cast<uint32_t>(w.mean)) >> 9);
  if (static_cast<uint32_t>(value) > 0xFFFFu) mean_n = 0xFFFFu;
  w.mean = static_cast<int32_t>(mean_n);
  w.zmode = 0;
  // Zero-run mode: (mean << 2) < 512 as uint32 (a mean of 2^30 or more
  // enters too, as in Go).
  if ((mean_n << 2) < 512u && w.count < ln.ns) {
    int32_t k32 = __clz(w.mean) - 24 + static_cast<int32_t>((mean_n + 16u) >> 6);
    if (k32 < 0) k32 = 0;
    const int32_t mz = static_cast<int32_t>((shl32f(1u, k32) - 1u) & ln.wb_mask);
    const uint32_t zwin = buf.window();
    const int32_t zpre = __clz(static_cast<int32_t>(~zwin));
    int32_t zrun, zbits;
    if (zpre >= 9) {
      zrun = static_cast<int32_t>((zwin << 9) >> 16);
      zbits = 25;
    } else {
      // k32 may be anything from 0 up: the clamped shift gives 0 at 32 - k32
      // <= 0 as Go's does.
      const int32_t zv = static_cast<int32_t>(ushr32f(zwin << (zpre + 1), 32 - k32));
      const bool zvbig = zv >= 2;
      zrun = zvbig ? wadd(wmul(zpre, mz), zv - 1) : wmul(zpre, mz);
      zbits = zpre + 1 + (zvbig ? k32 : k32 - 1);
    }
    if (wadd(w.count, zrun) > ln.ns) {
      w.err = ERR_SAMPLES;
      w.act = false;
    } else {
      w.zrem = zrun;
      const int32_t off_z = wadd(w.off, zbits);
      buf.advance(zbits, off_z);
      w.off = off_z;
      w.zmode = zrun >= 65535 ? 0 : 1;
      w.mean = 0;
    }
  }
  return emit;
}

// A row off the common path: idle, one zero of a pending run drained, the
// overrun guard (golomb.go:168-170) tripped, or an escape codeword (a
// 9-one prefix, then max_size raw bits).
__device__ __forceinline__ int32_t rare_row(BitStream& buf, Walk& w, const WalkLane& ln, uint32_t pu) {
  int32_t emit = 0;
  if (!w.act) return 0;
  if (w.zrem > 0) {
    --w.zrem;
    ++w.count;
  } else if (w.zrem == 0) {
    if (w.off >= ln.sz || w.off < 0) {
      w.err = ERR_OVERRUN;
      w.act = false;
    } else {  // a prefix of nine ones: the common row took every other codeword
      buf.step(9);
      const int32_t value = static_cast<int32_t>(
          ushr32f(buf.window(), 32 - (ln.max_size > 1 ? ln.max_size : 1)));
      const int32_t off_new = wadd(w.off, 9 + ln.max_size);
      buf.advance(ln.max_size, off_new);
      w.off = off_new;
      emit = finish_codeword(buf, w, ln, pu, value);
    }
  }
  w.act = w.act && w.count < ln.ns && w.err == ERR_NONE;
  return emit;
}

// One pass of the walk (golomb.go:112-253): row t of the pass goes to
// out[t * stride] for every t < F_pad, the dense emission schedule of the TPU
// kernels: a lane decodes one codeword, drains one zero of a pending run,
// or idles and emits 0 (raw lanes take raw_pass).
//
// The loop is latency-bound: one warp to a scheduler at B=2048, and each
// row's codeword starts where the last one ended (off -> window -> prefix
// -> nbits -> off) with its k from the mean the last one left (mean -> k ->
// value -> mean).  The GPU pays for every instruction of a row in turn, and
// for every branch a warp's lanes split on, so the common row (active, no
// run pending, the cursor inside the packet, a prefix under 9) is one
// straight block: the window is one funnel shift, k one bfind, the word
// crossing is selects, the Go clamps are dropped where the counts are
// provably in range, and only the (rare) zero-run entry branches.  Every
// other row takes rare_row's branch.
__device__ __forceinline__ void walk_pass(
    BitStream& buf, Walk& w, const WalkLane& ln, int32_t pbl, int32_t* out, size_t stride,
    int F_pad) {
  if (ln.raw) {
    raw_pass(buf.s, w, ln, out, stride, F_pad);
    return;
  }
  const bool live = w.act;
  if (live && (!buf.ready || buf.pos != w.off)) buf.seek(w.off);
  const uint32_t pu = static_cast<uint32_t>(pbl);
  // The guard 0 <= off < sz as one unsigned compare (none passes for sz <= 0).
  const uint32_t szu = static_cast<uint32_t>(ln.sz > 0 ? ln.sz : 0);
  // One row of the schedule: its residual.
  auto row = [&]() -> int32_t {
    const uint32_t win = buf.window();
    const int32_t pre = __clz(static_cast<int32_t>(~win));
    if (!(w.act && w.zrem == 0 && pre < 9 && static_cast<uint32_t>(w.off) < szu)) {
      return rare_row(buf, w, ln, pu);
    }
    // k = min(lg3a(mean >> 9), kb): (mean >> 9) + 3 is at most 2^23 + 2
    // (unsigned shift of a uint32), so k <= 23, and k >= 1 unless kb < 1.
    const int32_t k = min(msb((static_cast<uint32_t>(w.mean) >> 9) + 3u), ln.kb);
    // pre + 1 <= 9: a plain shift.  32 - k is 9..32 (32 when kb is 0,
    // where Go's shift gives 0), and shl32(1, k) keeps Go's clamp for any
    // kb: both one funnel shift.
    const uint32_t v = ushr32f(win << (pre + 1), 32 - k);
    const int32_t m = static_cast<int32_t>(shl32f(1u, k) - 1u);
    const bool vbig = v >= 2u;
    const int32_t value = vbig ? wadd(wmul(pre, m), static_cast<int32_t>(v) - 1) : wmul(pre, m);
    // pre + 1 + (vbig ? k : k - 1): 0..32, since 0 <= k <= 23 (kb is the
    // cookie's byte, 0..255; the wrappers raise outside it), so one step
    // moves the stream.
    const int32_t nbits = pre + k + (vbig ? 1 : 0);
    w.off = wadd(w.off, nbits);
    buf.step(nbits);
    const int32_t emit = finish_codeword(buf, w, ln, pu, value);
    w.act = w.act && w.count < ln.ns && w.err == ERR_NONE;
    return emit;
  };
  // Rows in groups of kRowGroup (F_pad is a multiple of 16), their stores
  // after the group.
  for (int t = 0; t < F_pad; t += kRowGroup) {
    int32_t e[kRowGroup];
#pragma unroll
    for (int j = 0; j < kRowGroup; ++j) e[j] = row();
#pragma unroll
    for (int j = 0; j < kRowGroup; ++j) out[static_cast<size_t>(t + j) * stride] = e[j];
  }
  if (live) buf.pos = w.off;
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
  BitStream buf(s);
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
