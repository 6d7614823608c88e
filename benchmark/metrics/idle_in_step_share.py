"""idle_in_step_share (%, device trace), the device's layer: the share of
the traced window in which no device operation runs while the host is
inside an outermost program span (`nbx.step`, `nbx.shard.step`; see
step_loop_host_ms). `device_idle_share` is this share plus the idle time
while the host is outside the program: in the harness, waiting on its
events or in the window's closing synchronise. Nothing where the trace
holds no such span, or no device operation."""

from benchmark.metrics.step_loop_host_ms import OUTER, overlap, spans


def read(run):
    t = run.trace
    if t is None or not t.device or t.t1 <= t.t0:
        return None
    outer = spans(t, OUTER)
    if not outer:
        return None
    idle, prev = [], t.t0
    for s, e in t.busy() + [(t.t1, t.t1)]:
        if s > prev:
            idle.append([prev, s])
        prev = max(prev, e)
    return 100.0 * overlap(idle, outer) / (t.t1 - t.t0)
