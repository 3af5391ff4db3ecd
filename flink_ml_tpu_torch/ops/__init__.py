"""Hand-written CUDA kernels and their wrappers, and the shared numeric
code of the fits: losses, regularization and the SGD optimizer (the port's
``flink_ml_tpu.ops``). The exported names load on first use, so that
importing one submodule pulls in neither the optimizer nor the kernels."""

__all__ = ["BinaryLogisticLoss", "HingeLoss", "LeastSquareLoss", "LossFunc",
           "regularize", "SGD", "SGDParams"]

#: name → its submodule
_LAZY = {"BinaryLogisticLoss": "losses", "HingeLoss": "losses",
         "LeastSquareLoss": "losses", "LossFunc": "losses",
         "regularize": "regularization", "SGD": "optimizer",
         "SGDParams": "optimizer"}


def __getattr__(name):
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
