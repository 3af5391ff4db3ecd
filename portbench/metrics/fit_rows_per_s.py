"""Rows of every fit the window completed, over the window's time (Flink
ML's ``inputThroughput`` without the data generation)."""


def read(run):
    return run.calls * run.rows_per_call / run.window_s
