"""Device operations (kernels, copies, sets) the host enqueued in the traced
window, per fit: the port's own kernels and PyTorch's operators alike."""


def read(run):
    if run.trace is None or run.trace.calls <= 0:
        return None
    count = run.trace.operations()
    return count / run.trace.calls if count else None
