"""host_call_ms (ms, host clock), the step loop's layer: the mean host time
of one call of the cell's entry, without a synchronise, over the window's
calls outside the traced ones. Far below the call's device time, the host
keeps ahead of the card; near it, the card waits for the host."""


def read(run):
    times = [t for k, t in enumerate(run.host_call_s) if k not in run.traced]
    return 1e3 * sum(times) / len(times) if times else None
