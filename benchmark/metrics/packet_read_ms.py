"""packet_read_ms (ms, container layer): host ms a crop in
``alac.decoder.packets`` (the facade's reads of each window's packets from
the container, one seek and one read a packet), its own time, from the
port's spans in the traced window; a crop as `open_ms` counts it."""

from benchmark.metrics.open_ms import per_crop_ms


def read(ctx):
    return per_crop_ms(ctx, "alac.decoder.packets")
