"""MP4/M4A container demux (host side)."""

from .demux import SampleInfo, find_alac_track

__all__ = ["SampleInfo", "find_alac_track"]
