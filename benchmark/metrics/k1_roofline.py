"""k1_roofline (%, device trace), the direct sum's layer (K1:
`ops/pairwise.pairwise_acc` -> `csrc/pairwise_f32r.cu` and its
`combine_splits` launch): the least time one force evaluation needs over the
time the card spent in K1's launches for one.

Least time: the larger of the law's operations over the float32 peak and
its bytes over the memory bandwidth (`benchmark.counts`: 26 operations an
unordered pair, the rank's share of N (N - 1) / 2). Device time: the traced
kernels whose names hold `KERNELS`, over the launches of `MAIN` (one an
evaluation). Nothing where the trace holds no K1 launch or the card has no
known peak."""

from benchmark import counts, peaks

MAIN = "pairwise_f32r_kernel"
KERNELS = (MAIN, "combine_splits")


def read(run):
    peak = peaks.for_card(run.kind)
    if run.trace is None or peak is None:
        return None
    launches = run.trace.count((MAIN,))
    if not launches:
        return None
    n = run.config["n"]
    bound = max(counts.direct_sum_ops(n, run.chips) / peak["fp32"],
                counts.direct_sum_bytes(n, run.chips) / peak["hbm"])
    return 100.0 * bound * launches / run.trace.device_s(KERNELS)
