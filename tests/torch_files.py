"""Container fixtures shared by the port's facade, service, CLI and
container tests: M4A and CAF files written by the JAX package's encoder and
muxers, from `conftest.music_pcm`."""

import dataclasses
import io

from conftest import expected_pcm_bytes, make_config, music_pcm

from saprobe_alac_tpu.caf import build_caf
from saprobe_alac_tpu.encoder import EncoderSpec, encode_packets
from saprobe_alac_tpu.encoder.mux import build_m4a
from saprobe_alac_tpu_torch import PacketConfig


@dataclasses.dataclass
class AlacFile:
    config: object  # the JAX package's PacketConfig
    pcm: object  # (n, C) int64 source samples
    packets: list
    spp: list
    blob: bytes

    @property
    def source(self) -> bytes:
        return expected_pcm_bytes(self.pcm, self.config.bit_depth)

    @property
    def port_config(self) -> PacketConfig:
        return PacketConfig(**dataclasses.asdict(self.config))

    def reader(self) -> io.BytesIO:
        return io.BytesIO(self.blob)


def alac_file(depth=16, channels=2, frame=128, n=1000, seed=0, bytes_shifted=0,
              container="m4a", rate=44100, wrap_cookie=False) -> AlacFile:
    cfg = make_config(depth=depth, channels=channels, frame_length=frame, sample_rate=rate)
    pcm = music_pcm(n, channels, depth, seed=seed)
    pkts = encode_packets(cfg, EncoderSpec(bytes_shifted=bytes_shifted), pcm)
    spp = [min(frame, n - i * frame) for i in range(len(pkts))]
    if container == "caf":
        blob = build_caf(cfg, pkts, spp)
    else:
        blob = build_m4a(cfg, pkts, spp, wrap_cookie=wrap_cookie)
    return AlacFile(cfg, pcm, pkts, spp, blob)
