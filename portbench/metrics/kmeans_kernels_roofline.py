"""The KMeans fits' floor over the device time of the kernels that are not
PyTorch's own: in the KMeans cells, ``csrc/kmeans_kernels.cu``'s (Lloyd's
two stages), from the traced window."""

from portbench.metrics import kernels_roofline as read  # noqa: F401
