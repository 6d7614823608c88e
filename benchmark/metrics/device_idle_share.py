"""device_idle_share (%, device trace), the device's layer: the share of the
traced calls' span in which no kernel, copy or set ran on the card."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
