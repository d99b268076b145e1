"""``ImageFeaturizer`` — headless-CNN image featurization.

Port of ``synapseml_tpu/dl/featurizer.py``: resize and normalize an image
column, run a vision model through the port's ``ONNXModel``, and emit the
penultimate features (``cut_output_layers=1``, "headless") or the logits
(``cut_output_layers=0``). The preprocessing is the reference's f32
operations in its order (resize, BGR -> RGB, ``x * scale``,
``(x - mean) / std``, NCHW), as torch ops on the stage's device; the
executor is fed that device tensor, which never goes through the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import ComplexParam, Param, Table, Transformer
from ..core.params import ParamValidators
from ..image.stages import ResizeImageTransformer
from ..onnx.model import ONNXModel
from ..runtime.device import resolve_device

__all__ = ["ImageFeaturizer"]

_IMAGENET_MEAN = [0.485, 0.456, 0.406]
_IMAGENET_STD = [0.229, 0.224, 0.225]


class ImageFeaturizer(Transformer):
    input_col = Param("image column", str, default="image")
    output_col = Param("output features column", str, default="features")
    model_name = Param("zoo model name (e.g. ResNet50); ignored if model_bytes set",
                       str, default="ResNet50")
    model_bytes = ComplexParam("explicit ONNX model bytes", bytes, default=None)
    model_dir = Param("local cache dir for downloaded models", str,
                      default="/tmp/synapseml_tpu_models")
    cut_output_layers = Param("1 = penultimate features (headless), 0 = logits", int,
                              default=1, validator=ParamValidators.in_range(0, 1))
    image_height = Param("input height", int, default=224)
    image_width = Param("input width", int, default=224)
    channel_order = Param("channel order of incoming images", str, default="bgr",
                          validator=ParamValidators.in_list(["bgr", "rgb"]))
    scale = Param("pixel pre-scale (1/255 for uint8 input)", float, default=1.0 / 255.0)
    mean = Param("per-channel normalization mean (rgb order)", list, default=_IMAGENET_MEAN)
    std = Param("per-channel normalization std (rgb order)", list, default=_IMAGENET_STD)
    batch_size = Param("inference bucket size", int, default=32, validator=ParamValidators.gt(0))
    dtype_policy = Param("float32 | bfloat16", str, default="float32",
                         validator=ParamValidators.in_list(["float32", "bfloat16"]))
    device = Param("'cuda[:i]' (default: the GPU) or 'cpu'", str, default=None)

    def __init__(self, uid=None, **kw):
        super().__init__(uid=uid, **kw)
        self._onnx: Optional[ONNXModel] = None

    def _post_load(self):
        self._onnx = None

    def _resolve_model(self) -> ONNXModel:
        if getattr(self, "_onnx", None) is not None:
            return self._onnx
        if self.model_bytes is not None:
            data = self.model_bytes
            input_name, feat, logits = "data", "features", "logits"
        else:
            from .downloader import ModelDownloader

            dl = ModelDownloader(self.model_dir)
            schema = dl.download_by_name(self.model_name)
            data = dl.local.read_bytes(schema)
            input_name, feat, logits = (schema.input_name, schema.feature_output,
                                        schema.logits_output)
        fetch = feat if self.cut_output_layers >= 1 else logits
        self._onnx = ONNXModel(
            feed_dict={input_name: "__img_nchw"},
            fetch_dict={self.output_col: fetch},
            batch_size=self.batch_size,
            dtype_policy=self.dtype_policy,
            device=self.device,
        ).set_model(data)
        return self._onnx

    def preprocess(self, col) -> torch.Tensor:
        """An image column -> the model's (N, 3, H, W) f32 input on the
        stage's device."""
        dev = resolve_device(self.device)
        x = ResizeImageTransformer(height=self.image_height, width=self.image_width,
                                   device=str(dev)).resize_tensor(col)
        if self.channel_order == "bgr":  # zoo models expect RGB
            x = torch.flip(x, (-1,))
        x = x * self.scale
        mean = torch.as_tensor(np.asarray(self.mean, np.float32), device=dev)
        std = torch.as_tensor(np.asarray(self.std, np.float32), device=dev)
        x = (x - mean) / std
        return x.permute(0, 3, 1, 2)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        nchw = self.preprocess(table[self.input_col])
        onnx = self._resolve_model()
        (name,) = onnx.feed_dict
        out = onnx.transform_arrays({name: nchw})
        return table.with_column(self.output_col, out[self.output_col])
