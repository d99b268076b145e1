"""Kernel build and binding (``csrc/*.cu`` -> ``ctypes``)."""

from .build import CudaKernel, build  # noqa: F401


def all_kernels():
    """The port's hand kernels, by name (importing their modules binds them)."""
    from ..gbdt import device_predict, histogram
    from ..parallel import flash

    return {k.name: k for k in (histogram.HIST_KERNEL, device_predict.SCORE_KERNEL,
                                flash.FLASH_KERNEL)}
