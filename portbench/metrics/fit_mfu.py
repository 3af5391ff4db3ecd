"""The whole fit's share of the card's peak: the least time of the fits the
measured window completed (the larger of their byte and operation bounds at
the published peaks, ``cost/<algorithm>.py``) over the window's time, in %.
"""

from portbench.cost import floor_s


def read(run):
    if not run.on_card:
        return None
    return 100.0 * run.calls * floor_s(run.call_bytes, run.call_ops) \
        / run.window_s
