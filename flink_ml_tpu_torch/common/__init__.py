"""Columnar tables (the port's ``flink_ml_tpu.common``)."""
