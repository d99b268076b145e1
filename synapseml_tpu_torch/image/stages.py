"""Image pipeline stages.

Port of ``synapseml_tpu/image/stages.py``: ``ImageTransformer`` (the
stage-list image pipeline), ``ResizeImageTransformer``, ``UnrollImage``,
``ImageSetAugmenter`` and ``UnrollBinaryImage``, with the same params and
defaults. Image columns are object columns of HWC arrays (ragged sizes) or
uniform ``(N, H, W, C)`` arrays; each stage moves the images to its
``device`` (default: the GPU), runs ``image/ops.py`` there, and writes host
arrays back into the table.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import ColumnSpec, Param, Table, TableSchema, Transformer, concat_tables
from ..core.params import ParamValidators
from ..runtime.device import resolve_device
from . import ops as iops

__all__ = ["ImageTransformer", "ResizeImageTransformer", "UnrollImage", "ImageSetAugmenter",
           "UnrollBinaryImage"]

_DEVICE_DOC = "'cuda[:i]' (default: the GPU) or 'cpu'"


def _to_batch(col) -> Optional[np.ndarray]:
    """Object column of uniform HWC arrays -> (N,H,W,C); None if ragged."""
    if isinstance(col, np.ndarray) and col.dtype != object:
        return col if col.ndim == 4 else None
    shapes = {np.asarray(v).shape for v in col}
    if len(shapes) == 1:
        return np.stack([np.asarray(v) for v in col])
    return None


def _on(arr, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class ImageTransformer(Transformer):
    """Sequential image-op pipeline encoded as a list of ``{"action": ..., params}``
    dicts (reference ``ImageTransformerStage.apply``). Supported actions:
    ``resize``, ``crop``, ``centercrop``, ``colorformat``, ``blur``,
    ``gaussiankernel``, ``threshold``, ``flip``, ``normalize``."""

    input_col = Param("input image column", str, default="image")
    output_col = Param("output image column", str, default="image")
    stages = Param("list of image op dicts with 'action' key", list, default=[])
    device = Param(_DEVICE_DOC, str, default=None)

    def input_schema(self):
        return TableSchema({self.input_col: ColumnSpec("any", "any")})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col, ColumnSpec("any", "image"))

    def _apply_stage(self, batch: torch.Tensor, stage: Dict[str, Any]) -> torch.Tensor:
        action = stage["action"].lower()
        if action == "resize":
            if "size" in stage:  # aspect-preserving shorter-side resize is per-image
                raise ValueError("resize with 'size' must be applied pre-batch (ragged)")
            return iops.resize(batch, int(stage["height"]), int(stage["width"]))
        if action == "crop":
            return iops.crop(batch, int(stage["x"]), int(stage["y"]),
                             int(stage["width"]), int(stage["height"]))
        if action == "centercrop":
            return iops.center_crop(batch, int(stage["width"]), int(stage["height"]))
        if action == "colorformat":
            return iops.color_convert(batch, stage["format"])
        if action == "blur":
            return iops.box_blur(batch, int(stage["height"]), int(stage["width"]))
        if action == "gaussiankernel":
            return iops.gaussian_blur(batch, int(stage["aperturesize"]),
                                      float(stage.get("sigma", -1.0)))
        if action == "threshold":
            return iops.threshold(batch, float(stage["threshold"]), float(stage["maxval"]),
                                  stage.get("thresholdtype", "binary"))
        if action == "flip":
            return iops.flip(batch, int(stage.get("flipcode", 1)))
        if action == "normalize":
            return iops.normalize(batch, stage["mean"], stage["std"],
                                  float(stage.get("scale", 1.0)))
        raise ValueError(f"unknown image action {action!r}")

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        dev = resolve_device(self.device)
        col = table[self.input_col]
        host = _to_batch(col)
        stages = list(self.stages)
        batch = None if host is None else _on(host, dev)
        if batch is None:
            # Ragged: resolve per-image until a uniform-size op (resize) appears.
            imgs = [_on(np.asarray(v), dev) for v in col]
            while stages:
                st = dict(stages[0])
                action = st["action"].lower()
                if action == "resize" and "size" in st:
                    imgs = [iops.resize_shorter(im, int(st["size"])) for im in imgs]
                    stages.pop(0)
                    continue
                if action == "resize":
                    h, w = int(st["height"]), int(st["width"])
                    imgs = [iops.resize(im[None], h, w)[0] for im in imgs]
                    stages.pop(0)
                    batch = torch.stack(imgs)
                    break
                imgs = [self._apply_stage(im[None], st)[0] for im in imgs]
                stages.pop(0)
            if batch is None:
                if len({tuple(im.shape) for im in imgs}) == 1:
                    batch = torch.stack(imgs)
                else:
                    out = np.empty(len(imgs), dtype=object)
                    for i, im in enumerate(imgs):
                        out[i] = _host(im)
                    return table.with_column(self.output_col, out, meta={"type": "image"})
        for st in stages:
            batch = self._apply_stage(batch, st)
        return table.with_column(self.output_col, _host(batch), meta={"type": "image"})


class ResizeImageTransformer(Transformer):
    """Opencv-free resize (reference ``core/.../image/ResizeImageTransformer.scala``)."""

    input_col = Param("input image column", str, default="image")
    output_col = Param("output image column", str, default="image")
    height = Param("target height", int, default=224, validator=ParamValidators.gt(0))
    width = Param("target width", int, default=224, validator=ParamValidators.gt(0))
    device = Param(_DEVICE_DOC, str, default=None)

    def input_schema(self):
        return TableSchema({self.input_col: ColumnSpec("any", "any")})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col, ColumnSpec("any", "image"))

    def resize_tensor(self, col) -> torch.Tensor:
        """The column's images resized to (height, width), as one f32
        (N, H, W, C) tensor on the stage's device."""
        dev = resolve_device(self.device)
        batch = _to_batch(col)
        if batch is not None:
            return iops.resize(_on(batch, dev), self.height, self.width)
        return torch.stack([iops.resize(_on(np.asarray(v), dev)[None], self.height,
                                        self.width)[0] for v in col])

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        out = _host(self.resize_tensor(table[self.input_col]))
        return table.with_column(self.output_col, out, meta={"type": "image"})


class UnrollImage(Transformer):
    """Flatten image column into a feature vector column, CHW order
    (reference ``core/.../image/UnrollImage.scala``)."""

    input_col = Param("input image column", str, default="image")
    output_col = Param("output vector column", str, default="features")

    def input_schema(self):
        return TableSchema({self.input_col: ColumnSpec("any", "image")})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col, ColumnSpec("float", "vector"))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        batch = _to_batch(table[self.input_col])
        if batch is None:
            raise ValueError(
                f"UnrollImage({self.uid}): images must be uniform size (resize first)")
        n = batch.shape[0]
        chw = np.transpose(batch, (0, 3, 1, 2))
        return table.with_column(self.output_col, chw.reshape(n, -1).astype(np.float32))


class ImageSetAugmenter(Transformer):
    """Dataset augmentation by mirroring (reference ``ImageSetAugmenter.scala``):
    emits original rows plus flipped copies, multiplying the row count."""

    input_col = Param("image column", str, default="image")
    output_col = Param("output image column", str, default="image")
    flip_left_right = Param("add horizontal mirrors", bool, default=True)
    flip_up_down = Param("add vertical mirrors", bool, default=False)
    device = Param(_DEVICE_DOC, str, default=None)

    def input_schema(self):
        return TableSchema({self.input_col: ColumnSpec("any", "image")})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        out = schema.with_column(self.output_col, ColumnSpec("any", "image"))
        if self.output_col != self.input_col:
            out = out.drop(self.input_col)
        return out

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        batch = _to_batch(table[self.input_col])
        if batch is None:
            raise ValueError(f"ImageSetAugmenter({self.uid}): resize images first")
        on = _on(batch, resolve_device(self.device))
        tables = [table.with_column(self.output_col, batch, meta={"type": "image"})]
        if self.flip_left_right:
            tables.append(table.with_column(self.output_col, _host(iops.flip(on, 1)),
                                            meta={"type": "image"}))
        if self.flip_up_down:
            tables.append(table.with_column(self.output_col, _host(iops.flip(on, 0)),
                                            meta={"type": "image"}))
        if self.output_col != self.input_col:
            tables = [t.drop(self.input_col) if self.input_col in t else t for t in tables]
        return concat_tables(tables)


class UnrollBinaryImage(Transformer):
    """Decode a binary (bytes) image column and unroll to a CHW vector
    (reference ``UnrollBinaryImage``): optional ``width``/``height`` resize
    to a uniform target; undecodable / None rows yield None."""

    input_col = Param("binary image column", str, default="image")
    output_col = Param("output vector column", str, default="features")
    width = Param("target width (resize when set)", int, default=None)
    height = Param("target height (resize when set)", int, default=None)
    n_channels = Param("target channel count", int, default=None)
    device = Param(_DEVICE_DOC, str, default=None)

    def input_schema(self):
        return TableSchema({self.input_col: ColumnSpec("object", "scalar")})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col, ColumnSpec("float", "vector"))

    def _transform(self, table: Table) -> Table:
        from ..io.binary import decode_image

        if (self.width is None) != (self.height is None):
            raise ValueError(
                f"UnrollBinaryImage({self.uid}): width and height must be "
                "set together to resize (got width="
                f"{self.width}, height={self.height})")
        if self.width is not None and (self.width <= 0 or self.height <= 0):
            raise ValueError(
                f"UnrollBinaryImage({self.uid}): width/height must be "
                f"positive (got {self.width}x{self.height})")
        self._validate_input(table, self.input_col)
        dev = resolve_device(self.device) if self.width is not None else None
        col = table[self.input_col]
        n = table.num_rows
        decoded: List[Optional[np.ndarray]] = []
        for r in range(n):
            v = col[r]
            if v is None:
                decoded.append(None)
                continue
            try:
                img = decode_image(bytes(v))
            except Exception:
                decoded.append(None)
                continue
            if self.width is not None:
                img = _host(iops.resize(_on(np.asarray(img, np.float32), dev)[None],
                                        self.height, self.width)[0])
            if self.n_channels:
                c = img.shape[-1]
                if c == 1 and self.n_channels == 3:
                    img = np.repeat(img, 3, axis=-1)
                elif c != self.n_channels:
                    img = img[..., : self.n_channels]
            decoded.append(np.asarray(img, np.float32))
        shapes = {d.shape for d in decoded if d is not None}
        if len(shapes) > 1:
            raise ValueError(
                f"UnrollBinaryImage({self.uid}): decoded sizes differ "
                f"({sorted(shapes)}); set width/height to resize")
        out = np.empty(n, dtype=object)
        for r, img in enumerate(decoded):
            if img is not None:
                out[r] = np.transpose(img, (2, 0, 1)).ravel().astype(np.float32)
        return table.with_column(self.output_col, out)
