"""Host helpers: WAV container I/O and PCM byte conversion."""

from .pcmconv import array_to_pcm_bytes, pcm_bytes_to_array
from .wav import read_wav, wav_header, write_wav

__all__ = ["array_to_pcm_bytes", "pcm_bytes_to_array", "read_wav", "wav_header", "write_wav"]
