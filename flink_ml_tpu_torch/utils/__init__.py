"""Persistence helpers (the port's ``flink_ml_tpu.utils``)."""
