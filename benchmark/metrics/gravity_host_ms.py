"""gravity_host_ms (ms, device trace), the direct sum's layer (`sim.gravity`
and the sharded steps' `_local_acc`: the dispatch, the float4 pack, the
partials' allocation, the K1 and `combine_splits` launches): the mean host
time of one force evaluation, over the program's `nbx.gravity` spans in the
traced window (one a force evaluation). Nothing where the trace holds no
such span, or no device operation (off the card the force itself runs
inside the span)."""

SPAN = "nbx.gravity"


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    hits = [e - s for name, s, e in t.host if name == SPAN]
    if not hits:
        return None
    return 1e-3 * sum(hits) / len(hits)
