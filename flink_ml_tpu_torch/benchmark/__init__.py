"""JSON-config benchmark harness (the port's ``flink_ml_tpu.benchmark``)."""
