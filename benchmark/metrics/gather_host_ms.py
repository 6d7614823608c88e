"""gather_host_ms (ms, device trace), the collectives' layer
(`parallel/shard._gather`: the message's concatenation, the NCCL
all-gather's launch and the fields' views): the host time of the program's
`nbx.gather` spans in the traced window, over the traced calls' steps.
Nothing where the trace holds no such span, or no device operation (off the
card the collective itself runs inside the span)."""

SPAN = "nbx.gather"


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    hits = [e - s for name, s, e in t.host if name == SPAN]
    if not hits:
        return None
    return 1e-3 * sum(hits) / (t.calls * run.steps_per_call)
