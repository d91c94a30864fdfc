// Frozen copy of native/alac_encode.cpp at commit d146ec009c2c24691c94e65e7d8eb983445d6db9,
// kept for the benchmark's input maker (benchmark/inputs.py): the yardstick may
// not change when the program's own encoder does.
//
// Native (C++) ALAC packet encoder core.
//
// Exact inverse of the decode math (same approach as the Python encoder in
// saprobe_alac_tpu/encoder/encode.py): minimal-representative residuals via
// the decoder's own recurrence, lockstep adaptive Golomb-Rice state, actual
// zero-run encoding, verbatim (escape) auto-fallback.  The Python layer
// computes initial LPC coefficients (cheap) and calls this for the
// per-sample loops.
//
// C ABI; bound via ctypes next to alac_core.cpp (one shared library).

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

static inline uint32_t e_shl32(uint32_t x, uint32_t s) { return s >= 32 ? 0u : x << s; }
static inline int32_t e_sshr32(int32_t x, uint32_t s) {
  if (s >= 32) return x < 0 ? -1 : 0;
  return x >> s;
}
static inline int32_t e_sext_bits(int32_t x, uint32_t bits) {
  uint32_t cs = 32u - bits;
  return e_sshr32(static_cast<int32_t>(e_shl32(static_cast<uint32_t>(x), cs)), cs);
}
static inline int32_t e_lead_zeros(uint32_t x) { return x == 0 ? 32 : __builtin_clz(x); }
static inline int32_t e_lg3a(uint32_t x) { return 31 - e_lead_zeros(x + 3u); }

struct BitSink {
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  uint32_t nbits = 0;

  void write(uint64_t value, uint32_t numbits) {
    if (!numbits) return;
    value &= (numbits >= 64) ? ~0ull : ((1ull << numbits) - 1);
    acc = (acc << numbits) | value;
    nbits += numbits;
    while (nbits >= 8) {
      nbits -= 8;
      out->push_back(static_cast<uint8_t>(acc >> nbits));
    }
    acc &= (1ull << nbits) - 1;
  }
  void write_ones(uint32_t count) {
    while (count > 32) { write(0xFFFFFFFFu, 32); count -= 32; }
    write((1ull << count) - 1, count);
  }
  void byte_align() { if (nbits) write(0, 8 - nbits); }
  uint64_t bit_length() const { return out->size() * 8ull + nbits; }
};

static void append_bits(BitSink& dst, const BitSink& src) {
  for (uint8_t b : *src.out) dst.write(b, 8);
  if (src.nbits) dst.write(src.acc, src.nbits);
}

static void rice_code(BitSink& w, uint32_t value, uint32_t m, uint32_t k,
                      uint32_t max_size, uint32_t max_prefix) {
  uint32_t q = m > 0 ? value / m : max_prefix;
  if (q >= max_prefix) {
    w.write_ones(max_prefix);
    w.write(value, max_size);
    return;
  }
  w.write_ones(q);
  w.write(0, 1);
  if (k == 1) return;
  uint32_t r = value - q * m;
  if (r == 0) w.write(0, k - 1);
  else w.write(r + 1, k);
}

// Inverse of dyn_decomp (golomb.go): residuals in, codes out.
static void ag_encode(BitSink& w, const int32_t* res, int32_t num,
                      uint32_t mb0, uint32_t pb, uint32_t kb, uint32_t wb,
                      uint32_t max_size) {
  uint32_t mean = mb0;
  int32_t zmode = 0;
  int32_t i = 0;
  while (i < num) {
    int32_t d = res[i];
    uint32_t n = d >= 0 ? 2u * static_cast<uint32_t>(d)
                        : static_cast<uint32_t>(-2ll * d - 1);
    uint32_t value = n - static_cast<uint32_t>(zmode);

    uint32_t m = mean >> 9;
    uint32_t k = static_cast<uint32_t>(e_lg3a(m));
    if (k > kb) k = kb;
    m = e_shl32(1, k) - 1;
    rice_code(w, value, m, k, max_size, 9);
    ++i;

    mean = pb * n + mean - ((pb * mean) >> 9);
    if (value > 0xFFFFu) mean = 0xFFFFu;
    zmode = 0;

    if ((mean << 2) < 512u && i < num) {
      zmode = 1;
      int32_t k32 = e_lead_zeros(mean) - 24 + static_cast<int32_t>((mean + 16) >> 6);
      if (k32 < 0) k32 = 0;
      uint32_t mz = (e_shl32(1, static_cast<uint32_t>(k32)) - 1) & wb;
      uint32_t run = 0;
      while (i + static_cast<int32_t>(run) < num && res[i + run] == 0 && run < 65535u) ++run;
      rice_code(w, run, mz, static_cast<uint32_t>(k32), 16, 9);
      i += run;
      zmode = (run >= 65535u) ? 0 : 1;
      mean = 0;
    }
  }
}

// Forward LPC: residuals such that the decoder's reconstruct() inverts them
// (minimal-representative residual; see encoder/encode.py docstring).
static void lpc_forward(const int32_t* x, int32_t* res, int32_t num,
                        const int16_t* coefs_in, int32_t order,
                        uint32_t chan_bits, uint32_t den_shift) {
  if (num <= 0) return;
  res[0] = x[0];
  if (order == 0) {
    for (int32_t i = 1; i < num; ++i) res[i] = x[i];
    return;
  }
  if (order == 31) {
    for (int32_t i = 1; i < num; ++i) res[i] = e_sext_bits(x[i] - x[i - 1], chan_bits);
    return;
  }
  for (int32_t i = 1; i <= order && i < num; ++i)
    res[i] = e_sext_bits(x[i] - x[i - 1], chan_bits);

  const bool wrap16 = !(order == 4 || order == 5 || order == 6 || order == 8);
  const int32_t den_half = den_shift > 0 ? 1 << (den_shift - 1) : 0;
  int32_t c[32];
  for (int32_t k = 0; k < order; ++k) c[k] = coefs_in[k];

  for (int32_t idx = order + 1; idx < num; ++idx) {
    const int32_t top = x[idx - 1 - order];
    int32_t acc = 0;
    for (int32_t k = 0; k < order; ++k) acc += c[k] * (x[idx - 1 - k] - top);
    const int32_t sum1 = e_sshr32(acc + den_half, den_shift);

    const int32_t del = e_sext_bits(x[idx] - top - sum1, chan_bits);
    res[idx] = del;
    if (del == 0) continue;
    const int32_t sign = del > 0 ? 1 : -1;

    int32_t del0 = del;
    for (int32_t j = 1; j <= order; ++j) {
      const int32_t k = order - j;
      const int32_t dd = top - x[idx - 1 - k];
      const int32_t sgn = (dd > 0 ? 1 : dd < 0 ? -1 : 0) * sign;
      int32_t nc = c[k] - sgn;
      c[k] = wrap16 ? static_cast<int16_t>(nc) : nc;
      del0 -= j * e_sshr32(sgn * dd, den_shift);
      if (sign > 0 ? del0 <= 0 : del0 >= 0) break;
    }
  }
}

struct EncSpec {
  int32_t order;
  int32_t den_shift;
  int32_t pb_factor;
  int32_t mode;
  int32_t mix_bits;
  int32_t mix_res;
  int32_t bytes_shifted;
  int32_t force_escape;
  int32_t auto_escape;
  int32_t use_lfe_tag;
  int32_t fit;        // 1: per-channel per-packet Levinson-Durbin fit
  int16_t coefs[32];  // fallback / caller-pinned initial coefficients
};

// Per-channel per-packet LPC fit: autocorrelation + Levinson-Durbin on the
// post-mix channel data (what the predictor actually sees), quantized to
// den_shift fixed point.  The decoder's model is
//   pred[i] = top + (sum_k c_k * (x[i-1-k] - top)) >> den_shift,
// whose 'top' offset absorbs DC exactly, so mapping the classical
// a_k (x^[i] = sum a_k x[i-k]) directly onto c_{k-1} = a_k * 2^shift keeps
// constant signals exact while inheriting the Levinson optimum elsewhere.
// Returns false (caller keeps sp.coefs) on degenerate input.
static bool fit_coefs(const int32_t* x, int32_t ns, int32_t order,
                      int32_t den_shift, int16_t* out) {
  if (order <= 0 || order >= 31 || ns < 4 * order + 8) return false;
  double mean = 0.0;
  for (int32_t i = 0; i < ns; ++i) mean += x[i];
  mean /= ns;
  std::vector<double> d(ns);
  for (int32_t i = 0; i < ns; ++i) d[i] = x[i] - mean;
  std::vector<double> R(order + 1, 0.0);
  for (int32_t k = 0; k <= order; ++k) {
    double s = 0.0;
    for (int32_t i = k; i < ns; ++i) s += d[i] * d[i - k];
    R[k] = s;
  }
  if (!(R[0] > 0.0)) return false;
  R[0] *= 1.0 + 1e-9;  // tiny ridge so err stays positive
  std::vector<double> a(order + 1, 0.0), prev(order + 1);
  double err = R[0];
  for (int32_t i = 1; i <= order; ++i) {
    double acc = R[i];
    for (int32_t j = 1; j < i; ++j) acc -= a[j] * R[i - j];
    double k = acc / err;
    if (!std::isfinite(k)) return false;
    if (k > 0.999) k = 0.999;
    if (k < -0.999) k = -0.999;
    prev = a;
    a[i] = k;
    for (int32_t j = 1; j < i; ++j) a[j] = prev[j] - k * prev[i - j];
    err *= (1.0 - k * k);
    if (!(err > 0.0)) return false;
  }
  for (int32_t k = 1; k <= order; ++k) {
    double q = std::round(a[k] * static_cast<double>(1 << den_shift));
    if (q > 30000.0) q = 30000.0;
    if (q < -30000.0) q = -30000.0;
    out[k - 1] = static_cast<int16_t>(q);
  }
  return true;
}

struct EncConfig {
  uint32_t frame_length, bit_depth, num_channels, pb, mb, kb, max_run;
};

// MPEG element order -> SMPTE source channel (mirror of encode.py).
static const int kEncLayout[8][8] = {
    {0}, {0, 1}, {2, 0, 1}, {2, 0, 1, 3}, {2, 0, 1, 3, 4},
    {2, 0, 1, 4, 5, 3}, {2, 0, 1, 4, 5, 6, 3}, {2, 6, 7, 0, 1, 4, 5, 3}};

static void element_header(BitSink& w, int tag, bool partial, int bs, int esc, uint32_t ns) {
  w.write(tag, 3);
  w.write(0, 4);  // element instance tag
  w.write(0, 12);
  w.write((static_cast<uint32_t>(partial) << 3) | (bs << 1) | esc, 4);
  if (partial) { w.write(ns >> 16, 16); w.write(ns & 0xFFFF, 16); }
}

// Returns false when the residuals are uncodable (INT32_MIN at
// chan_bits==32: the decoder's ((nd+1)>>1) wraps it to 0); the caller then
// falls back to the verbatim element.
static bool entropy_body(BitSink& w, const EncConfig& cfg, const EncSpec& sp,
                         const int32_t* hs, int32_t ns, uint32_t chan_bits,
                         const int16_t* coefs, std::vector<int32_t>& scratch) {
  scratch.resize(ns);
  lpc_forward(hs, scratch.data(), ns, coefs, sp.order, chan_bits, sp.den_shift);
  if (sp.mode != 0) {
    // Stream carries delta'd residuals (decoder un-deltas first).
    int32_t prev = scratch[0];
    for (int32_t i = 1; i < ns; ++i) {
      int32_t cur = scratch[i];
      scratch[i] = e_sext_bits(cur - prev, chan_bits);
      prev = cur;
    }
  }
  if (chan_bits >= 32) {
    for (int32_t i = 0; i < ns; ++i)
      if (scratch[i] == INT32_MIN) return false;
  }
  uint32_t wb = cfg.kb < 32 ? e_shl32(1, cfg.kb) - 1 : 0xFFFFFFFFu;
  ag_encode(w, scratch.data(), ns, cfg.mb, (cfg.pb * sp.pb_factor) / 4,
            cfg.kb, wb, chan_bits);
  return true;
}

static void encode_element(BitSink& dst, const EncConfig& cfg, const EncSpec& sp,
                           int tag, const int32_t* ch0, const int32_t* ch1,
                           int32_t ns, bool partial, std::vector<int32_t>& scratch) {
  const bool pair = ch1 != nullptr;
  const uint32_t depth = cfg.bit_depth;
  const uint32_t dmask = depth >= 32 ? 0xFFFFFFFFu : ((1u << depth) - 1);

  // Escape (verbatim) variant.
  std::vector<uint8_t> esc_bytes;
  BitSink esc{&esc_bytes};
  element_header(esc, tag, partial, 0, 1, ns);
  for (int32_t i = 0; i < ns; ++i) {
    esc.write(static_cast<uint32_t>(ch0[i]) & dmask, depth);
    if (pair) esc.write(static_cast<uint32_t>(ch1[i]) & dmask, depth);
  }
  if (sp.force_escape) {
    append_bits(dst, esc);
    return;
  }

  // Compressed variant.
  // Shift bits are only re-inserted by the 24/32-bit writers (matrix.go).
  int bs = depth >= 24 ? sp.bytes_shifted : 0;
  if (pair && depth == 32 && bs == 0) bs = 1;  // avoid degenerate chanBits=33
  const uint32_t chan_bits = depth - bs * 8 + (pair ? 1 : 0);
  const uint32_t shift = bs * 8;
  const uint32_t smask = shift ? ((1u << shift) - 1) : 0;

  std::vector<uint8_t> cmp_bytes;
  BitSink cmp{&cmp_bytes};
  element_header(cmp, tag, partial, bs, 0, ns);

  std::vector<int32_t> h0(ns), h1;
  std::vector<uint32_t> l0, l1;
  if (bs) l0.resize(ns);
  for (int32_t i = 0; i < ns; ++i) {
    h0[i] = bs ? (ch0[i] >> shift) : ch0[i];
    if (bs) l0[i] = static_cast<uint32_t>(ch0[i]) & smask;
  }
  if (pair) {
    h1.resize(ns);
    if (bs) l1.resize(ns);
    for (int32_t i = 0; i < ns; ++i) {
      h1[i] = bs ? (ch1[i] >> shift) : ch1[i];
      if (bs) l1[i] = static_cast<uint32_t>(ch1[i]) & smask;
    }
  }

  int32_t mix_bits = 0, mix_res = 0;
  if (pair) {
    mix_res = sp.mix_res;
    mix_bits = mix_res != 0 ? sp.mix_bits : 0;
    if (mix_res != 0) {
      // Inverse of unmix: v = l - r; u = r + ((mix_res * v) >> mix_bits).
      // Decorrelated values must fit chan_bits (the decoder sign-extends),
      // else fall back to independent channels for losslessness.
      const int64_t lim = 1ll << (chan_bits - 1);
      bool overflow = false;
      std::vector<int32_t> u0(ns), v0(ns);
      for (int32_t i = 0; i < ns; ++i) {
        int64_t v = static_cast<int64_t>(h0[i]) - h1[i];
        int64_t u = h1[i] + ((static_cast<int64_t>(mix_res) * v) >> mix_bits);
        if (u >= lim || u < -lim || v >= lim || v < -lim) { overflow = true; break; }
        u0[i] = static_cast<int32_t>(u);
        v0[i] = static_cast<int32_t>(v);
      }
      if (overflow) {
        mix_res = 0;
        mix_bits = 0;
      } else {
        h0.swap(u0);
        h1.swap(v0);
      }
    }
  }
  cmp.write(static_cast<uint32_t>(mix_bits), 8);
  cmp.write(static_cast<uint32_t>(mix_res) & 0xFF, 8);

  // Per-channel initial coefficients: the Levinson-Durbin fit on the
  // post-mix data each predictor will actually see, falling back to the
  // caller's coefficients when fitting is off or the input is degenerate.
  int16_t fitted[2][32];
  const int16_t* coefs[2] = {sp.coefs, sp.coefs};
  for (int c = 0; c < (pair ? 2 : 1); ++c) {
    const int32_t* hs = (c == 0 ? h0.data() : h1.data());
    if (sp.fit && fit_coefs(hs, ns, sp.order, sp.den_shift, fitted[c]))
      coefs[c] = fitted[c];
  }

  // Predictor headers + coefs for every channel (decoder.go:421-448)...
  for (int c = 0; c < (pair ? 2 : 1); ++c) {
    cmp.write((sp.mode << 4) | sp.den_shift, 8);
    cmp.write((sp.pb_factor << 5) | sp.order, 8);
    for (int32_t k = 0; k < sp.order; ++k)
      cmp.write(static_cast<uint16_t>(coefs[c][k]), 16);
  }
  // ...then the shift region (decoder.go:453-457)...
  if (bs) {
    for (int32_t i = 0; i < ns; ++i) {
      cmp.write(l0[i], shift);
      if (pair) cmp.write(l1[i], shift);
    }
  }
  // ...then the entropy bodies.
  bool codable = entropy_body(cmp, cfg, sp, h0.data(), ns, chan_bits, coefs[0], scratch);
  if (codable && pair)
    codable = entropy_body(cmp, cfg, sp, h1.data(), ns, chan_bits, coefs[1], scratch);

  if (!codable || (sp.auto_escape && esc.bit_length() < cmp.bit_length()))
    append_bits(dst, esc);
  else append_bits(dst, cmp);
}

}  // namespace

extern "C" {

// Encode one packet.  samples: interleaved SMPTE (ns * channels) int32.
// Returns byte size written to out, or negative on error.
int32_t alac_encode_packet(const EncConfig* cfg, const EncSpec* sp,
                           const int32_t* samples, int32_t ns,
                           uint8_t* out, int64_t out_cap) {
  const uint32_t C = cfg->num_channels;
  if (C < 1 || C > 8) return -1;
  if (sp->order < 0 || sp->order > 31) return -1;
  const bool partial = static_cast<uint32_t>(ns) != cfg->frame_length;

  const int* layout = kEncLayout[C - 1];
  static const int widths[8][5] = {{1}, {2}, {1, 2}, {1, 2, 1}, {1, 2, 2},
                                   {1, 2, 2, 1}, {1, 2, 2, 1, 1}, {1, 2, 2, 2, 1}};
  static const int nelems[8] = {1, 1, 2, 3, 3, 4, 5, 5};
  // Bitstream channel index of the LFE channel per channel count (0 = none).
  static const int lfe_idx[9] = {-1, -1, -1, -1, -1, -1, 5, 6, 7};

  std::vector<std::vector<int32_t>> planes(C, std::vector<int32_t>(ns));
  for (int32_t i = 0; i < ns; ++i)
    for (uint32_t c = 0; c < C; ++c) planes[c][i] = samples[i * C + c];

  std::vector<uint8_t> bytes;
  BitSink w{&bytes};
  std::vector<int32_t> scratch;

  int chan = 0;
  for (int e = 0; e < nelems[C - 1]; ++e) {
    if (widths[C - 1][e] == 1) {
      int tag = (sp->use_lfe_tag && chan == lfe_idx[C]) ? 3 : 0;
      encode_element(w, *cfg, *sp, tag, planes[layout[chan]].data(), nullptr,
                     ns, partial, scratch);
      chan += 1;
    } else {
      encode_element(w, *cfg, *sp, 1, planes[layout[chan]].data(),
                     planes[layout[chan] + 1].data(), ns, partial, scratch);
      chan += 2;
    }
  }
  w.write(7, 3);  // END
  w.byte_align();

  if (static_cast<int64_t>(bytes.size()) > out_cap) return -2;
  std::memcpy(out, bytes.data(), bytes.size());
  return static_cast<int32_t>(bytes.size());
}

}  // extern "C"
