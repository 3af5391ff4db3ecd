"""The port's iteration runtime (so far: the unbounded stream plumbing)."""
