"""allgather_device_ms (ms, device trace), the collectives' layer
(`parallel/shard._gather`, one `all_gather_into_tensor` a step over NCCL):
the device time of the NCCL all-gather kernels a step. A kernel that waits
for a slower rank counts its wait, so the ranks' skew shows here."""

KERNELS = ("AllGather",)


def read(run):
    if run.trace is None:
        return None
    hits = [op for op in run.trace.matching(KERNELS) if "nccl" in op[0].lower()]
    if not hits:
        return None
    return 1e3 * sum(e - s for _, s, e in hits) * 1e-6 / (run.trace.calls * run.steps_per_call)
