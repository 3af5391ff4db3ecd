"""The general parts of the benchmark: generators, the run, the trace."""
