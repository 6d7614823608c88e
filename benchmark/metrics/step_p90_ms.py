"""step_p90_ms (ms, lower is better, device clock): the 90th percentile,
over every call of the window, of the call's time over its steps. A call's
time runs between the CUDA events recorded after it and after the call
before it, so it counts any time the card waited for the host."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile([s / run.steps_per_call for s in run.call_s], 90))
