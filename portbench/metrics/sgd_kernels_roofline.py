"""The LR fits' floor over the device time of the kernels that are not
PyTorch's own: in the LR cells, ``csrc/sgd_kernels.cu``'s (SGD's stage 1
and the combine), from the traced window."""

from portbench.metrics import kernels_roofline as read  # noqa: F401
