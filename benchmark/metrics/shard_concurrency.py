"""shard_concurrency (count, parallel layer): how many shards' host stages
run at once in a sharded call: the summed durations of the shards' own
``alac.batch.submit`` and ``alac.batch.finish`` spans (each nested directly
in the call's top-level span of the same name) over the summed durations
of those top-level spans, from the port's spans in the traced window.
Shards that run one after another on the caller's thread read at most 1;
four that overlap fully read 4.  None without a sharded call."""

from benchmark.port_spans import window_spans

CALL = ("alac.batch.submit", "alac.batch.finish")


def read(ctx):
    spans = window_spans(ctx)
    if spans is None:
        return None
    top = {s.id: s for s in spans if s.name in CALL and s.parent is None}
    shards = [s for s in spans if s.parent in top and s.name == top[s.parent].name]
    calls = {s.parent for s in shards}
    shard_ns = sum(s.end_ns - s.start_ns for s in shards)
    call_ns = sum(top[i].end_ns - top[i].start_ns for i in calls)
    return shard_ns / call_ns if shard_ns and call_ns else None
