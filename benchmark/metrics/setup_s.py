"""setup_s (s, lower is better, host clock): process start to the window's
start: imports, loading the kernels' libraries (building them in a
checkout's first run), the scene, the program's set-up and the warm-up."""


def read(run):
    return run.setup_s
