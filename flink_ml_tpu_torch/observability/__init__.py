"""Model-health checks (the port's ``flink_ml_tpu.observability``; this
slice has the always-on final-state guard only)."""
