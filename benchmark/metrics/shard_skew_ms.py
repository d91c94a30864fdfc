"""shard_skew_ms (ms, parallel layer): how unevenly the cards of a sharded
call finish their work, from the device trace.  A traced call runs from
its harness ``bench.submit`` span to the end of the ``bench.sync`` after
it, which waits for every card; per call, the end of the latest card's
last device operation less the earliest card's, averaged over the calls
in which two cards or more ran something.  None on one card."""

import bisect

SUBMIT, SYNC = "bench.submit", "bench.sync"


def read(ctx):
    t = ctx.trace
    if t is None or len(t.devices) < 2:
        return None
    ops = {d: sorted((o.end_ns, o.start_ns) for o in t.ops if o.device == d) for d in t.devices}
    ends = {d: [e for e, _ in v] for d, v in ops.items()}
    skews, start = [], None
    for s, e, name in sorted((s, e, n) for n, s, e in t.spans if n in (SUBMIT, SYNC)):
        if name == SUBMIT:
            start = s
            continue
        if start is None:
            continue
        last = []
        for d in t.devices:  # each card's last operation ending by the sync's end
            i = bisect.bisect_right(ends[d], e) - 1
            if i >= 0 and ops[d][i][1] >= start:
                last.append(ops[d][i][0])
        if len(last) > 1:
            skews.append(max(last) - min(last))
        start = None
    return sum(skews) / len(skews) / 1e6 if skews else None
