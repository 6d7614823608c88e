"""step_loop_host_ms (ms, device trace), the step loop's layer: the host
time of a step in the program's own step loop, outside its force and its
gather. It is the time the host spends inside the outermost program spans
(`nbx.step`, a frame of `sim.step`; `nbx.shard.step`, a step of the sharded
steps) less the time their `nbx.gravity` and `nbx.gather` spans cover, over
the traced calls' steps: the kicks, the drift, the event log and the Python
between them.

The spans are the program's `torch.profiler.record_function` ranges
(`nbx_torch.profiling.span`), on the trace's clock. Nothing where the trace
holds no such span, or no device operation: off the card the work itself
runs inside the spans, so their time is not the host's share of a step."""

OUTER = ("nbx.step", "nbx.shard.step")
INNER = ("nbx.gravity", "nbx.gather")


def union(intervals) -> list:
    """The union of [(start, end)] as sorted disjoint [[start, end]]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def spans(trace, names) -> list:
    """The union of the host spans named in `names` (the trace keeps those
    inside its window, clipped to it)."""
    return union((s, e) for name, s, e in trace.host if name in names)


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    outer = spans(t, OUTER)
    if not outer:
        return None
    inside = sum(e - s for s, e in outer) - overlap(outer, spans(t, INNER))
    return 1e-3 * inside / (t.calls * run.steps_per_call)
