"""From the start of the process to the window: imports, builds or loads of
the kernels, the inputs made on the device, the warm-up calls."""


def read(run):
    return run.setup_s
