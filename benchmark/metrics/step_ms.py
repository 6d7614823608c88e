"""step_ms (ms, lower is better, host clock): the window's wall time over
the physics steps completed in it. The window starts after set-up and ends
in torch.cuda.synchronize(); a step is one KDK substep."""


def read(run):
    return 1e3 * run.window_s / (run.calls * run.steps_per_call)
