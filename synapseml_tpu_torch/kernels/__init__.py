"""Kernel build and binding (``csrc/*.cu`` -> ``ctypes``)."""

from .build import CudaKernel, build  # noqa: F401


def all_kernels():
    """The port's hand kernels, by name (importing their modules binds them)."""
    from ..explainers import regression
    from ..gbdt import device_predict, histogram, lambdarank, partition, sparse, split_search
    from ..isolationforest import forest
    from ..nn import topk
    from ..onnx import qgemm, rnn
    from ..parallel import flash
    from ..vw import learner

    return {k.name: k for k in (histogram.HIST_KERNEL, histogram.HIST_ROWS_KERNEL,
                                histogram.SIBLING_KERNEL, partition.PARTITION_KERNEL,
                                partition.PARTITION_MESH_KERNEL,
                                partition.PARTITION_PICK_KERNEL,
                                device_predict.SCORE_KERNEL, device_predict.LEAF_KERNEL,
                                device_predict.BIN_KERNEL,
                                split_search.SPLIT_KERNEL, sparse.SPARSE_HIST_KERNEL,
                                sparse.SPARSE_HIST_MESH_KERNEL,
                                lambdarank.LAMBDARANK_KERNEL,
                                flash.FLASH_KERNEL, flash.FLASH_F32_KERNEL,
                                flash.FLASH_LSE_KERNEL, flash.FLASH_F32_LSE_KERNEL,
                                learner.VW_KERNEL, qgemm.QMATMUL_KERNEL, qgemm.QCONV_KERNEL,
                                qgemm.QCL_KERNEL,
                                rnn.RNN_KERNEL, rnn.RNN_STEP_KERNEL,
                                regression.LASSO_KERNEL, forest.IFOREST_KERNEL,
                                topk.TOPK_KERNEL)}
