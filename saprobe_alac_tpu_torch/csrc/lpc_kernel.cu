// LPC kernel: adaptive LPC reconstruction, decode direction.
//
// Replaces the TPU kernel saprobe_alac_tpu/ops/lpc_kernel.py `_lpc_kernel`
// with forward=False (entry `lpc_fir_pallas`).  One thread runs one
// (packet, channel) lane through predictor.go:45-684: the mode > 0 delta
// pre-pass, prediction from a history of the last TAPS outputs with rounding
// by den and sign extension to chan_bits, and the coefficient sign walk
// (predictor.go:660-682) with the int16 wrap unless the order is 4/5/6/8.
// Lane classes: 0 passes the residual through, 1 runs the adaptive FIR,
// 2 runs order-31 delta as a fixed order-1 FIR without adaptation.
//
// What bounds it on an H100: the recurrence is serial in t and each sample
// is a dependent chain of O(TAPS) integer ops, so with L = 4096 lanes
// (B=2048 stereo) on 32 SMs the kernel is latency-bound, not
// bandwidth-bound (it moves 8 bytes per sample).  The design keeps the
// history and the coefficients in registers, templated on TAPS (9 or 32)
// with fully unrolled static indexing; `top = hist[order]` is a select loop,
// because a dynamic register index would spill to local memory.  At a given
// t every thread reads and writes row t, so the F-major rows coalesce across
// a warp; the walk's rows are read in place (lane = c*S + s reads row t of
// channel block c), with no merge or relayout in between.  Residual loads
// run ahead of the recurrence (see kRows).

#include <cuda_runtime.h>

#include <cstdint>

#include "alac_int.cuh"

namespace {

using namespace alac;

constexpr int kThreads = 128;

template <int TAPS>
__global__ void __launch_bounds__(kThreads) lpc_kernel(
    const int32_t* __restrict__ res, int S, int F_src, const int32_t* __restrict__ fir,
    const int32_t* __restrict__ order, const int32_t* __restrict__ den,
    const int32_t* __restrict__ cb, const int32_t* __restrict__ ns,
    const int32_t* __restrict__ wrap16, const int32_t* __restrict__ mode,
    const int32_t* __restrict__ coefs_t, int32_t* __restrict__ out, int F_pad, int L) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  const int32_t* src = res + static_cast<size_t>(l / S) * F_src * S + (l % S);
  const int32_t cls = fir[l], ord = order[l], dn = den[l], cbits = cb[l], nsl = ns[l];
  const bool w16 = wrap16[l] != 0, is_mode = mode[l] != 0;
  // The select tree of the TPU kernel over the history padded to a power of
  // two: indices past TAPS read 0.
  constexpr int kP2 = TAPS <= 16 ? 16 : 32;
  const int tsel = ord & (kP2 - 1);
  const int32_t den_half = dn > 0 ? static_cast<int32_t>(shl32(1u, dn - 1)) : 0;

  int32_t hist[TAPS], c[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    hist[k] = 0;
    c[k] = coefs_t[static_cast<size_t>(k) * L + l];
  }
  int32_t prev = 0;
  // Residual rows arrive kRows at a time, the next block's loads issued
  // before this block's rows are computed, so the load latency overlaps the
  // serial recurrence (F_pad is a multiple of 16).  Eight rows ahead cut the
  // 9-tap kernel by a quarter; at 32 taps the extra registers cost more than
  // they hide, so that variant runs one row ahead.
  constexpr int kRows = TAPS <= 16 ? 8 : 1;
  int32_t cur[kRows], nxt[kRows] = {};
#pragma unroll
  for (int j = 0; j < kRows; ++j) cur[j] = src[static_cast<size_t>(j) * S];
  for (int t0 = 0; t0 < F_pad; t0 += kRows) {
    if (t0 + kRows < F_pad) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) nxt[j] = src[static_cast<size_t>(t0 + kRows + j) * S];
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int t = t0 + j;
      const int32_t delta_raw = cur[j];
      int32_t delta = delta_raw;
      if (is_mode) {  // two-stage delta pre-pass (decoder.go:307-309)
        if (t >= 1) delta = sext(wadd(prev, delta_raw), cbits);
        prev = delta;
      }
      const bool active = cls >= 1 && t < nsl && t >= 1;
      int32_t top = 0;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) top = (k == tsel) ? hist[k] : top;

      // Prediction (predictor.go:647-656): wrapping int32 dot.
      uint32_t acc = 0;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        if (k < ord) acc += static_cast<uint32_t>(c[k]) * static_cast<uint32_t>(wsub(hist[k], top));
      }
      const int32_t sum1 = sshr32(wadd(static_cast<int32_t>(acc), den_half), dn);
      const bool warm = t <= ord;
      int32_t row = delta;
      if (active) {
        row = warm ? sext(wadd(delta, hist[0]), cbits) : sext(wadd(wadd(delta, top), sum1), cbits);
      }
      out[static_cast<size_t>(t) * L + l] = row;

      // Coefficient adaptation (predictor.go:660-682): tap k runs while the
      // remaining error keeps the sign of delta, walking k = order-1 .. 0.
      const int32_t sign = sgn(delta);
      if (active && cls == 1 && sign != 0 && !warm) {
        uint32_t T = 0;  // sum of the contributions of the taps above k
#pragma unroll
        for (int k = TAPS - 1; k >= 0; --k) {
          if (k < ord) {
            const int32_t dd = wsub(top, hist[k]);
            const int32_t sg = sgn(dd) * sign;
            const int32_t del0 = wsub(delta, static_cast<int32_t>(T));
            if (sign > 0 ? del0 > 0 : del0 < 0) {
              const int32_t nc = wsub(c[k], sg);
              c[k] = w16 ? sext16(nc) : nc;
            }
            T += static_cast<uint32_t>(wmul(ord - k, sshr32(wmul(sg, dd), dn)));
          }
        }
      }
#pragma unroll
      for (int k = TAPS - 1; k > 0; --k) hist[k] = hist[k - 1];
      hist[0] = row;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) cur[j] = nxt[j];
  }
}

template <int TAPS>
int launch(const void* res, int S, int F_src, const void* fir, const void* order,
           const void* den, const void* cb, const void* ns, const void* wrap16,
           const void* mode, const void* coefs_t, void* out, int F_pad, int L, void* stream) {
  if (L > 0) {
    lpc_kernel<TAPS><<<(L + kThreads - 1) / kThreads, kThreads, 0,
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

extern "C" int alac_lpc_launch_9(const void* res, int S, int F_src, const void* fir,
                                 const void* order, const void* den, const void* cb,
                                 const void* ns, const void* wrap16, const void* mode,
                                 const void* coefs_t, void* out, int F_pad, int L,
                                 void* stream) {
  return launch<9>(res, S, F_src, fir, order, den, cb, ns, wrap16, mode, coefs_t, out,
                   F_pad, L, stream);
}

extern "C" int alac_lpc_launch_32(const void* res, int S, int F_src, const void* fir,
                                  const void* order, const void* den, const void* cb,
                                  const void* ns, const void* wrap16, const void* mode,
                                  const void* coefs_t, void* out, int F_pad, int L,
                                  void* stream) {
  return launch<32>(res, S, F_src, fir, order, den, cb, ns, wrap16, mode, coefs_t, out,
                    F_pad, L, stream);
}
