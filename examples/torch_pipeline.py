#!/usr/bin/env python
"""End-to-end pipeline on one card: ALAC packets -> PCM -> spectral features.

The port's device-resident consumption model: compressed packets cross to
the card once; decode (`TorchBatchDecoder.decode_async`), float conversion
and feature extraction (`ops.audio`) all run there, and only the (much
smaller) features come back to the host.  ``--cpu`` runs every kernel's
plain version and the features on the CPU.

    python examples/torch_pipeline.py [--cpu] [--batch N] [--frame F]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="plain versions on the CPU")
    ap.add_argument("--batch", type=int, default=64, help="packets")
    ap.add_argument("--frame", type=int, default=4096, help="samples a packet")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from saprobe_alac_tpu_torch.config import PacketConfig
    from saprobe_alac_tpu_torch.encoder import EncoderSpec, encode_packets
    from saprobe_alac_tpu_torch.ops.audio import log_spectrogram, pcm_to_float
    from saprobe_alac_tpu_torch.ops.batch import TorchBatchDecoder
    from saprobe_alac_tpu_torch.ops.walk import ERR_NONE

    device = "cpu" if args.cpu else "cuda"
    rate, depth, F = 44100, 16, args.frame
    cfg = PacketConfig(frame_length=F, bit_depth=depth, num_channels=2, pb=40, mb=10, kb=14,
                       max_run=255, max_frame_bytes=0, avg_bit_rate=0, sample_rate=rate)
    t = np.arange(F * args.batch)
    pcm = np.stack([(12000 * np.sin(2 * np.pi * t / 90)).astype(np.int64),
                    (12000 * np.sin(2 * np.pi * t / 131)).astype(np.int64)], axis=1)
    packets = encode_packets(cfg, EncoderSpec(), pcm, backend="native")
    print(f"{len(packets)} packets, {sum(map(len, packets)) / 1e6:.2f} MB compressed")

    dec = TorchBatchDecoder(cfg, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def features_from(handle):
        packed, err, _, _ = handle
        if not bool((err[: len(packets)] == ERR_NONE).all()):
            raise RuntimeError("a packet failed on the device path")
        # 16-bit stereo `packed` rows: int32 words of two LE int16 samples,
        # (B, F*C/2) -> (B, F, 2) int16 -> (B, F) mono float -> features.
        samples = packed.contiguous().view(torch.int16).reshape(packed.shape[0], F, 2)
        mono = pcm_to_float(samples, depth).mean(dim=-1)
        return log_spectrogram(mono[: len(packets)])

    features_from(dec.decode_async(packets))  # warm: first launches build and load
    sync()
    t0 = time.perf_counter()
    feats = features_from(dec.decode_async(packets)).cpu().numpy()
    dt = time.perf_counter() - t0
    audio_s = len(packets) * F / rate
    print(f"decode+features on {device}: {dt * 1e3:.1f} ms for {audio_s:.1f} s of audio "
          f"({audio_s / dt:.0f}x realtime), features {feats.shape} "
          f"({feats.nbytes / 1e6:.2f} MB back to the host)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
