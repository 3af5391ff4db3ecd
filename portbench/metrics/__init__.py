"""One reader a metric: ``metrics/<name>.py`` with ``read(run)``, which
returns the metric's value from a :class:`~portbench.harness.bench.Run`, or
None where the run holds nothing to read (the harness then leaves the
metric out of the line). The share of a roofline that two layers' metrics
read alike is here."""

from __future__ import annotations

from portbench.cost import floor_s


def kernels_roofline(run):
    """The least time the card could take for the traced window's calls
    (their bytes or operations at the published peaks,
    ``cost/<algorithm>.py``) over the device time of every kernel that is
    not one of PyTorch's own operators, in %. In a cell whose work is one
    algorithm's, those are that algorithm's kernels, and a kernel that a
    later program adds counts with them. None without a trace or such
    kernels."""
    if run.trace is None:
        return None
    seconds = run.trace.program_kernel_seconds()
    if seconds <= 0:
        return None
    return 100.0 * run.trace.calls * floor_s(run.call_bytes, run.call_ops) \
        / seconds
