"""lock_wait_ms (ms, program layer): host ms a crop in
``alac.program.wait`` (a caller waiting for a program's lock while another
thread fills and replays the same key), summed over the threads, from the
port's spans in the traced window; a crop as `open_ms` counts it."""

from benchmark.metrics.open_ms import per_crop_ms


def read(ctx):
    return per_crop_ms(ctx, "alac.program.wait")
