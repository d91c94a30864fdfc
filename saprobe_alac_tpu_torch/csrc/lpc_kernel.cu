// LPC kernel: adaptive LPC, the decode direction (reconstruction) and the
// encode direction (residuals).
//
// Replaces the TPU kernel saprobe_alac_tpu/ops/lpc_kernel.py `_lpc_kernel`
// (entry `lpc_fir_pallas`), forward=False and forward=True.  One thread runs
// one (packet, channel) lane through predictor.go:45-684: the mode > 0 delta
// pre-pass, prediction from a history of the last outputs with rounding by
// den and sign extension to chan_bits, and the coefficient sign walk
// (predictor.go:660-682) with the int16 wrap unless the order is 4/5/6/8.
// Lane classes: 0 passes the residual through, 1 runs the adaptive FIR,
// 2 runs order-31 delta as a fixed order-1 FIR without adaptation.
//
// The encode direction (FWD) is the same recurrence solved for the residual:
// the input row is the signal x[t], the history holds past x (so only the
// coefficients are carried from row to row), the output is
// sext(x - prediction), and mode > 0 is a delta POST-pass on the residual
// row (the decoder un-deltas first).  Prediction and adaptation are one code
// for both directions.
//
// What bounds it on an H100: the recurrence is serial in t, so with L = 4096
// lanes (B=2048 stereo) each warp sits alone on its scheduler and a row
// costs the instructions it issues plus whatever of its dependent chain
// they cannot cover; the kernel moves 8 bytes a sample and is far from its
// bytes bound.  So the design cuts the instructions of a row and the chain
// from one row to the next:
// - Bodies specialized by order.  A lane that is class 1 at order 4, 5, 6
//   or 8 (the reference's unrolled orders, predictor.go:99-618, which are
//   also the orders with int32 coefficients) runs a body with the order,
//   the taps, top = hist[ORDER] and the absent int16 wrap fixed at compile
//   time: no tap past the order is issued.  Every other lane runs the
//   general loop over TAPS taps.  The choice is made for a group of 32
//   lanes (a warp) from the group's inputs (`group_body`): a group of such
//   lanes at one order runs that order's body; a group of such lanes at
//   several orders (an encoder that picks the order per packet, such as 4
//   or 8) runs each lane's own body, the warp running each body in turn;
//   a group with any other lane runs the general loop for every lane, since
//   its warp would run that loop anyway.  Each thread reads its group's
//   inputs, so the host-C++ harness, which runs threads one after another,
//   takes the body the card takes.
// - A short chain from row to row.  The prediction adds the newest sample's
//   term, c[0]*(hist[0] - top), last to the sum of the older taps.  The
//   sign walk's partial sums (delta minus the contributions of the taps
//   above k) are formed from the history and, in decode, from delta, the
//   input, before the row's output is known; in the forward direction the
//   contributions for either sign of the residual are formed before that
//   sign is known and then selected.  Rows are straight-line code (selects,
//   no branch), so the compiler interleaves neighbouring rows.
// - Shift counts made safe once per lane (`Lane`), not at every use.
// The history and the coefficients live in registers (fully unrolled static
// indexing; the general loop's `top = hist[order]` is a select loop, because
// a dynamic register index would spill to local memory).  At a given t every
// thread reads and writes row t, so the F-major rows coalesce across a warp;
// the walk's rows are read in place (lane = c*S + s reads row t of channel
// block c).  Residual loads run ahead of the recurrence (see `Lanes`).

#include <cuda_runtime.h>

#include <cstdint>

#include "alac_int.cuh"

namespace {

using namespace alac;

// Blocks of 32 and 128 threads timed within 1% of each other on the main
// paths' inputs and 32 ahead by 5% on the 32-tap loop
// (hack/torch_lpc_variants.py): one warp a scheduler either way.
constexpr int kThreads = 32;

// The per-lane settings every body reads, with each shift made safe once:
// - dsh = min(den as uint32, 31): x >> dsh == sshr32(x, den) for every den,
//   since a count of 31 already fills with the sign, which is what sshr32
//   gives for counts >= 32 and for negative ones (huge as uint32);
// - sext(x, cb) == keep & ((x << cs) >> cs) with cs = 32 - cb in [0, 31]
//   and keep = -1 where 1 <= cb <= 32; where cb > 32 or cb < 1, sext gives
//   0 (alac_int.cuh), so keep = 0 and cs = 0;
// - the int16 wrap of a coefficient is (c << w16) >> w16, w16 = 16 or 0.
struct Lane {
  int32_t cls, ord, ns, dsh, den_half, cs, keep, w16;
  bool mode;
};

__device__ __forceinline__ Lane make_lane(int32_t cls, int32_t ord, int32_t dn, int32_t cb,
                                          int32_t ns, int32_t wrap16, int32_t mode) {
  const bool ok = cb >= 1 && cb <= 32;
  Lane q;
  q.cls = cls;
  q.ord = ord;
  q.ns = ns;
  q.dsh = static_cast<int32_t>(min(static_cast<uint32_t>(dn), 31u));
  q.den_half = dn > 0 ? static_cast<int32_t>(shl32(1u, dn - 1)) : 0;
  q.cs = ok ? 32 - cb : 0;
  q.keep = ok ? -1 : 0;
  q.w16 = wrap16 != 0 ? 16 : 0;
  q.mode = mode != 0;
  return q;
}

// Lanes that choose their bodies together: a warp.
constexpr int kGroup = 32;

// The body lane l runs (ORDER 4, 5, 6 or 8, or 0: the general loop), from
// the inputs of its group of kGroup lanes within L.  A lane has a body of
// its own when it is class 1 at order 4, 5, 6 or 8 with int32 coefficients
// (wrap16 0) and 1 <= cb <= 32; it runs that body when every lane of its
// group has one.  A choice made by each lane from its own inputs alone ran
// uniform groups 15-23% slower (hack/torch_lpc_variants.py).
__device__ __forceinline__ int group_body(const int32_t* __restrict__ fir,
                                          const int32_t* __restrict__ order,
                                          const int32_t* __restrict__ cb,
                                          const int32_t* __restrict__ wrap16, int l, int L) {
  const int g0 = l & ~(kGroup - 1);
  const int g1 = min(g0 + kGroup, L);
  const int32_t o0 = order[g0];
  bool special = true, same = true;
  for (int k = g0; k < g1; ++k) {
    const int32_t o = order[k];
    special &= (o == 4 || o == 5 || o == 6 || o == 8) && fir[k] == 1 && wrap16[k] == 0 &&
               cb[k] >= 1 && cb[k] <= 32;
    same &= o == o0;
  }
  return !special ? 0 : same ? o0 : order[l];
}

__device__ __forceinline__ int32_t wneg(int32_t x) { return wsub(0, x); }
// |x| with wrapping: |INT32_MIN| == INT32_MIN, as sgn(x) * x in int32.
__device__ __forceinline__ int32_t wabs(int32_t x) { return x < 0 ? wneg(x) : x; }

// out[k] = x - (in[k+1] + ... + in[N-1]), k = 0..N-1 (in[0] is not read),
// as the plain version's exclusive suffix sums: a running difference within
// each block of four taps, started from x less the sums of the blocks above
// it.  Each block's differences are independent of the other blocks', and
// the blocks are joined by one sum each, not by one chain through every tap.
template <int N>
__device__ __forceinline__ void less_above(int32_t x, const int32_t (&in)[N], int32_t (&out)[N]) {
  constexpr int kBlock = 4;
  int32_t base = x;
#pragma unroll
  for (int b0 = (N - 1) / kBlock * kBlock; b0 >= 0; b0 -= kBlock) {
    int32_t run = base;
#pragma unroll
    for (int k = (b0 + kBlock < N ? b0 + kBlock : N) - 1; k >= b0; --k) {
      out[k] = run;
      if (k > 0) run = wsub(run, in[k]);
    }
    if (b0 > 0) {
      int32_t blk = 0;
#pragma unroll
      for (int k = b0; k < (b0 + kBlock < N ? b0 + kBlock : N); ++k) blk = wadd(blk, in[k]);
      base = wsub(base, blk);
    }
  }
}

// One lane's recurrence.  ORDER 0 is the general loop over TAPS taps with
// the lane's order at run time; ORDER 4, 5, 6 or 8 a specialized body.
template <int TAPS, bool FWD, int ORDER>
struct Body {
  static constexpr bool kGeneral = ORDER == 0;
  static constexpr int N = kGeneral ? TAPS : ORDER;      // coefficients
  static constexpr int H = kGeneral ? TAPS : ORDER + 1;  // history; top = hist[ORDER]
  const Lane q;
  int32_t tsel;
  int32_t hist[H], c[N], prev;

  __device__ __forceinline__ Body(const int32_t* __restrict__ coefs_t, int l, int L,
                                  const Lane& lane)
      : q(lane), prev(0) {
    // The select tree of the TPU kernel over the history padded to a power
    // of two: indices past TAPS read 0.
    constexpr int kP2 = TAPS <= 16 ? 16 : 32;
    tsel = q.ord & (kP2 - 1);
#pragma unroll
    for (int k = 0; k < H; ++k) hist[k] = 0;
    // Coefficients past the order are 0 and stay 0 (the sign walk never
    // adapts them), so the prediction needs no mask.
#pragma unroll
    for (int k = 0; k < N; ++k) {
      c[k] = (!kGeneral || k < q.ord) ? coefs_t[static_cast<size_t>(k) * L + l] : 0;
    }
  }

  // sign extension to chan_bits; a specialized lane has 1 <= cb <= 32
  // (group_body), so keep is -1 there.
  __device__ __forceinline__ int32_t sx(int32_t x) const {
    const int32_t v = static_cast<int32_t>(static_cast<uint32_t>(x) << q.cs) >> q.cs;
    return kGeneral ? (v & q.keep) : v;
  }

  // The sign walk's weight of tap k, order - k, and 0 past the order.
  __device__ __forceinline__ int32_t weight(int k) const {
    return kGeneral ? (k < q.ord ? q.ord - k : 0) : ORDER - k;
  }

  // top = hist[tsel] as an OR of masked taps: a select of loads here would
  // let the compiler fold it into one load at a dynamic index and keep the
  // history in local memory.
  __device__ __forceinline__ int32_t top() const {
    if (!kGeneral) return hist[ORDER];
    int32_t v = 0;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) v |= hist[k] & -static_cast<int32_t>(k == tsel);
    return v;
  }

  // Row t: x is the residual (decode) or the signal (FWD); returns the
  // output row.  EDGE rows may be t == 0 or warm (t <= order); a
  // specialized body's later rows are neither.
  template <bool EDGE>
  __device__ __forceinline__ int32_t step(int32_t x, int t) {
    const bool first = EDGE && t == 0;
    const int32_t ord = kGeneral ? q.ord : ORDER;
    int32_t delta = x;
    if (!FWD) {  // two-stage delta pre-pass (decoder.go:307-309)
      delta = (q.mode && !first) ? sx(wadd(prev, x)) : x;
      prev = delta;
    }
    const bool active = (!kGeneral || q.cls >= 1) && t < q.ns && !first;
    const bool warm = EDGE && t <= ord;
    const int32_t tp = top();

    // Prediction (predictor.go:647-656): wrapping int32 dot, the older taps
    // first and the newest sample's term last.
    int32_t d[N];
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = wsub(hist[k], tp);
    uint32_t acc = static_cast<uint32_t>(q.den_half);
#pragma unroll
    for (int k = N - 1; k >= 1; --k) {
      acc += static_cast<uint32_t>(c[k]) * static_cast<uint32_t>(d[k]);
    }
    acc += static_cast<uint32_t>(c[0]) * static_cast<uint32_t>(d[0]);
    const int32_t sum1 = static_cast<int32_t>(acc) >> q.dsh;

    int32_t row;
    if (FWD) {
      // The minimal representative of x - prediction mod 2^chan_bits, then
      // the delta post-pass on the residual row.
      delta = warm ? sx(wsub(x, hist[0])) : sx(wsub(wsub(x, tp), sum1));
      const int32_t r = active ? delta : x;
      row = (q.mode && !first) ? sx(wsub(r, prev)) : r;
      prev = r;
    } else {
      row = active ? (warm ? sx(wadd(delta, hist[0])) : sx(wadd(wadd(delta, tp), sum1))) : delta;
    }

    // Coefficient adaptation (predictor.go:660-682): tap k, walking
    // k = order-1 .. 0, adapts while delta less the contributions of the
    // taps above it keeps delta's sign.  With dd = top - hist[k] and
    // sg = sgn(dd) * sgn(delta), a contribution is
    // weight * (sg * dd >> den), and sg * dd == sgn(delta) * |dd|.
    const bool pos = delta > 0;
    int32_t dd[N], rest[N];
#pragma unroll
    for (int k = 0; k < N; ++k) dd[k] = wsub(tp, hist[k]);
    if (FWD) {
      int32_t con_up[N], con_dn[N], rest_up[N], rest_dn[N];
      con_up[0] = con_dn[0] = 0;
#pragma unroll
      for (int k = 1; k < N; ++k) {
        const int32_t a = wabs(dd[k]);
        con_up[k] = wmul(weight(k), a >> q.dsh);
        con_dn[k] = wmul(weight(k), wneg(a) >> q.dsh);
      }
      less_above(delta, con_up, rest_up);
      less_above(delta, con_dn, rest_dn);
#pragma unroll
      for (int k = 0; k < N; ++k) rest[k] = pos ? rest_up[k] : rest_dn[k];
    } else {
      int32_t con[N];
      con[0] = 0;
#pragma unroll
      for (int k = 1; k < N; ++k) {
        const int32_t a = wabs(dd[k]);
        con[k] = wmul(weight(k), (pos ? a : wneg(a)) >> q.dsh);
      }
      less_above(delta, con, rest);
    }
    // With delta != 0, "rest keeps delta's sign" is: rest and delta share
    // the sign bit and rest != 0.  Then c[k] -= sg, wrapped to int16 in the
    // general loop where the lane asks for it (also when sg is 0, as the
    // plain version does).
    const bool adapt = active && (!kGeneral || q.cls == 1) && !warm && delta != 0;
    const int32_t sign = pos ? 1 : -1;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const bool run = adapt && (rest[k] ^ delta) >= 0 && rest[k] != 0 && (!kGeneral || k < q.ord);
      const int32_t sg = dd[k] > 0 ? sign : (dd[k] < 0 ? -sign : 0);
      const int32_t nc = wsub(c[k], sg);
      const int32_t wc = static_cast<int32_t>(static_cast<uint32_t>(nc) << q.w16) >> q.w16;
      c[k] = run ? (kGeneral ? wc : nc) : c[k];
    }
#pragma unroll
    for (int k = H - 1; k > 0; --k) hist[k] = hist[k - 1];
    hist[0] = FWD ? x : row;  // the encoder's history is its input
    return row;
  }
};

// Residual rows arrive kRows at a time, the next block's loads issued
// before this block's rows are computed, so the load latency overlaps the
// serial recurrence (F_pad is a multiple of 16).  Sixteen rows took an
// order-4 decode 1-13% faster but the forward direction 15-55% and the
// general loop 5-8% slower; at 32 taps two and four rows were 6% and 77%
// slower than one (hack/torch_lpc_variants.py).
template <int TAPS, bool FWD, int ORDER>
struct Lanes {
  using B = Body<TAPS, FWD, ORDER>;
  static constexpr int kRows = (B::kGeneral && TAPS > 16) ? 1 : 8;

  // Rows t0 .. t0 + kRows - 1 from cur, loading the next block into nxt.
  template <bool EDGE>
  static __device__ __forceinline__ void block(B& b, const int32_t* __restrict__ src, int S,
                                               int32_t* __restrict__ out, int l, int L,
                                               int F_pad, int t0, int32_t (&cur)[kRows]) {
    int32_t nxt[kRows] = {};
    if (t0 + kRows < F_pad) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) nxt[j] = src[static_cast<size_t>(t0 + kRows + j) * S];
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      out[static_cast<size_t>(t0 + j) * L + l] = b.template step<EDGE>(cur[j], t0 + j);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) cur[j] = nxt[j];
  }

  // A specialized body runs its first blocks, which hold row 0 and the
  // warm rows t <= ORDER, apart, so its main loop is the common row alone.
  static __device__ __forceinline__ void run(const int32_t* __restrict__ src, int S,
                                             const int32_t* __restrict__ coefs_t,
                                             int32_t* __restrict__ out, int l, int L,
                                             int F_pad, const Lane& q) {
    B b(coefs_t, l, L, q);
    int32_t cur[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) cur[j] = src[static_cast<size_t>(j) * S];
    int t0 = 0;
    if (!B::kGeneral) {
      for (; t0 <= ORDER && t0 < F_pad; t0 += kRows) {
        block<true>(b, src, S, out, l, L, F_pad, t0, cur);
      }
    }
    for (; t0 < F_pad; t0 += kRows) block<B::kGeneral>(b, src, S, out, l, L, F_pad, t0, cur);
  }
};

template <int TAPS, bool FWD>
__global__ void __launch_bounds__(kThreads) lpc_kernel(
    const int32_t* __restrict__ res, int S, int F_src, const int32_t* __restrict__ fir,
    const int32_t* __restrict__ order, const int32_t* __restrict__ den,
    const int32_t* __restrict__ cb, const int32_t* __restrict__ ns,
    const int32_t* __restrict__ wrap16, const int32_t* __restrict__ mode,
    const int32_t* __restrict__ coefs_t, int32_t* __restrict__ out, int F_pad, int L) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  const int32_t* src = res + static_cast<size_t>(l / S) * F_src * S + (l % S);
  const Lane q = make_lane(fir[l], order[l], den[l], cb[l], ns[l], wrap16[l], mode[l]);
  switch (group_body(fir, order, cb, wrap16, l, L)) {
    case 4: Lanes<TAPS, FWD, 4>::run(src, S, coefs_t, out, l, L, F_pad, q); break;
    case 5: Lanes<TAPS, FWD, 5>::run(src, S, coefs_t, out, l, L, F_pad, q); break;
    case 6: Lanes<TAPS, FWD, 6>::run(src, S, coefs_t, out, l, L, F_pad, q); break;
    case 8: Lanes<TAPS, FWD, 8>::run(src, S, coefs_t, out, l, L, F_pad, q); break;
    default: Lanes<TAPS, FWD, 0>::run(src, S, coefs_t, out, l, L, F_pad, q); break;
  }
}

template <int TAPS, bool FWD>
int launch(const void* res, int S, int F_src, const void* fir, const void* order,
           const void* den, const void* cb, const void* ns, const void* wrap16,
           const void* mode, const void* coefs_t, void* out, int F_pad, int L, void* stream) {
  if (L > 0) {
    lpc_kernel<TAPS, FWD><<<(L + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(res), S, F_src, static_cast<const int32_t*>(fir),
        static_cast<const int32_t*>(order), static_cast<const int32_t*>(den),
        static_cast<const int32_t*>(cb), static_cast<const int32_t*>(ns),
        static_cast<const int32_t*>(wrap16), static_cast<const int32_t*>(mode),
        static_cast<const int32_t*>(coefs_t), static_cast<int32_t*>(out), F_pad, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ALAC_LPC_ENTRY(NAME, TAPS, FWD)                                                   \
  extern "C" int NAME(const void* res, int S, int F_src, const void* fir, const void* order, \
                      const void* den, const void* cb, const void* ns, const void* wrap16,   \
                      const void* mode, const void* coefs_t, void* out, int F_pad, int L,    \
                      void* stream) {                                                        \
    return launch<TAPS, FWD>(res, S, F_src, fir, order, den, cb, ns, wrap16, mode, coefs_t,  \
                             out, F_pad, L, stream);                                         \
  }

ALAC_LPC_ENTRY(alac_lpc_launch_9, 9, false)
ALAC_LPC_ENTRY(alac_lpc_launch_32, 32, false)
ALAC_LPC_ENTRY(alac_lpc_fwd_launch_9, 9, true)
ALAC_LPC_ENTRY(alac_lpc_fwd_launch_32, 32, true)
