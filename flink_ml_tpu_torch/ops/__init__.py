"""Hand-written CUDA kernels and their wrappers (the port's ``flink_ml_tpu.ops``)."""
