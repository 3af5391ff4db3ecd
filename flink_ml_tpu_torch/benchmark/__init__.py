"""JSON-config benchmark harness (the port's ``flink_ml_tpu.benchmark``):
the runner (``run_benchmark``, ``run_benchmarks``, ``load_config``,
``main``) and the param-driven data generators. The exported names load
on first use, so that importing ``datagen`` alone does not load the
runner and every stage it names."""

__all__ = ["DenseVectorArrayGenerator", "DenseVectorGenerator",
           "DoubleGenerator", "LabeledPointWithWeightGenerator",
           "RandomStringArrayGenerator", "RandomStringGenerator",
           "resolve_generator", "load_config", "main", "run_benchmark",
           "run_benchmarks"]

#: name → its submodule
_LAZY = {**{name: "datagen" for name in __all__[:7]},
         **{name: "runner" for name in __all__[7:]}}


def __getattr__(name):
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
