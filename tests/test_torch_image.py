"""The port's image ops and stages against the JAX package's, on the CPU.

Same seeded numpy images (uint8 and f32, odd sizes) through
``synapseml_tpu.image`` and ``synapseml_tpu_torch.image`` (``device="cpu"``).
Tolerance: exact for crops, flips, thresholds, channel swaps and
normalize; within ``ATOL`` (about 8 ulps at 255) for resize, the blurs and
``bgr2gray``, whose contractions and convolutions sum in another order than
XLA's CPU program (a few ulps at the images' 0-255 scale).
"""

import numpy as np
import pytest
import torch

from synapseml_tpu.core import Table as RefTable
from synapseml_tpu.image import ops as R
from synapseml_tpu.image import stages as RS
from synapseml_tpu_torch.core import Table, load_stage
from synapseml_tpu_torch.image import ops as P
from synapseml_tpu_torch.image import stages as PS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-4


def _images(dtype, n=3, h=13, w=11, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 255, size=(n, h, w, c))
    return x.astype(np.uint8) if dtype == "uint8" else (x + rng.random(x.shape)).astype(np.float32)


def _same(ref, port, atol=0.0):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert ref.shape == port.shape and ref.dtype == port.dtype, (ref.shape, port.shape,
                                                                  ref.dtype, port.dtype)
    if atol:
        np.testing.assert_allclose(port, ref, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("size,method", [((7, 5), "linear"), ((20, 17), "linear"),
                                         ((7, 17), "cubic"), ((26, 4), "cubic"),
                                         ((13, 11), "linear"), ((5, 9), "nearest")])
def test_resize(dtype, size, method):
    x = _images(dtype)
    _same(R.resize(x, *size, method=method), P.resize(torch.from_numpy(x), *size, method=method),
          ATOL)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("size", [6, 25])
def test_resize_shorter_keeps_python_round(dtype, size):
    x = _images(dtype, n=1, h=19, w=10)[0]
    _same(R.resize_shorter(x, size), P.resize_shorter(torch.from_numpy(x), size), ATOL)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_crop_center_crop_flip(dtype):
    x = _images(dtype)
    t = torch.from_numpy(x)
    _same(R.crop(x, 2, 1, 4, 6), P.crop(t, 2, 1, 4, 6))
    for w, h in ((4, 4), (5, 8), (30, 30)):
        _same(R.center_crop(x, w, h), P.center_crop(t, w, h))
    for code in (0, 1, 2, -1):
        _same(R.flip(x, code), P.flip(t, code))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("aperture", [3, 5, 7])
@pytest.mark.parametrize("sigma", [-1.0, 0.0, 1.3])
def test_gaussian_blur(dtype, aperture, sigma):
    x = _images(dtype)
    _same(R.gaussian_blur(x, aperture, sigma), P.gaussian_blur(torch.from_numpy(x), aperture,
                                                               sigma), ATOL)


@pytest.mark.parametrize("hw", [(3, 3), (5, 2), (1, 4)])
def test_box_blur(hw):
    x = _images("uint8")
    _same(R.box_blur(x, *hw), P.box_blur(torch.from_numpy(x), *hw), ATOL)


def test_gaussian_kernel_2d_is_the_references():
    for a, s in ((3, -1.0), (5, 0.0), (7, 2.5)):
        np.testing.assert_array_equal(R.gaussian_kernel_2d(a, s), P.gaussian_kernel_2d(a, s))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("kind", ["binary", "binary_inv", "trunc", "tozero", "tozero_inv"])
def test_threshold(dtype, kind):
    x = _images(dtype)
    _same(R.threshold(x, 100.3, 200.7, kind), P.threshold(torch.from_numpy(x), 100.3, 200.7,
                                                          kind))
    with pytest.raises(ValueError):
        P.threshold(torch.from_numpy(x), 1, 2, "otsu")


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("code", ["bgr2rgb", "rgb2bgr", "bgr2gray", "rgb2gray", "BGR2GRAY"])
def test_color_convert(dtype, code):
    x = _images(dtype)
    _same(R.color_convert(x, code), P.color_convert(torch.from_numpy(x), code),
          ATOL if "gray" in code.lower() else 0.0)


@pytest.mark.parametrize("code", ["gray2bgr", "gray2rgb"])
def test_gray_to_color(code):
    x = _images("uint8", c=1)
    _same(R.color_convert(x, code), P.color_convert(torch.from_numpy(x), code))
    with pytest.raises(ValueError):
        P.color_convert(torch.from_numpy(x), "hsv2bgr")


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_normalize(dtype):
    x = _images(dtype)
    _same(R.normalize(x, [1.5, 2, 3], [4, 5.5, 6], 0.5),
          P.normalize(torch.from_numpy(x), [1.5, 2, 3], [4, 5.5, 6], 0.5))


# -- stages ---------------------------------------------------------------------------

def _ragged(seed=2, sizes=((10, 8), (12, 12), (7, 9))):
    rng = np.random.default_rng(seed)
    col = np.empty(len(sizes), dtype=object)
    for i, (h, w) in enumerate(sizes):
        col[i] = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
    return col


def _assert_column(ref, port, atol=ATOL):
    ref, port = np.asarray(ref), np.asarray(port)
    assert ref.dtype == port.dtype and ref.shape == port.shape
    if ref.dtype == object:
        for a, b in zip(ref, port):
            _same(a, b, atol)
    else:
        _same(ref, port, atol)


STAGE_LISTS = {
    "batched": [{"action": "resize", "height": 8, "width": 8},
                {"action": "gaussiankernel", "aperturesize": 3, "sigma": 1.0},
                {"action": "centercrop", "height": 6, "width": 6},
                {"action": "flip", "flipcode": 1}],
    "every_action": [{"action": "crop", "x": 1, "y": 1, "width": 6, "height": 5},
                     {"action": "colorformat", "format": "bgr2rgb"},
                     {"action": "blur", "height": 3, "width": 3},
                     {"action": "threshold", "threshold": 90.0, "maxval": 250.0,
                      "thresholdtype": "tozero"},
                     {"action": "normalize", "mean": [1, 2, 3], "std": [2, 2, 2],
                      "scale": 0.5}],
    "shorter_then_crop": [{"action": "resize", "size": 9},
                          {"action": "centercrop", "height": 7, "width": 7},
                          {"action": "gaussiankernel", "aperturesize": 5},
                          {"action": "flip"}],
    "ragged_out": [{"action": "resize", "size": 6},
                   {"action": "colorformat", "format": "bgr2gray"}],
}


@pytest.mark.parametrize("name", sorted(STAGE_LISTS))
@pytest.mark.parametrize("ragged", [False, True])
def test_image_transformer(name, ragged, tmp_path):
    col = _ragged() if ragged else _images("uint8", n=4, h=12, w=10)
    stages = STAGE_LISTS[name]
    if not ragged and "size" in stages[0]:
        # a shorter-side resize runs image by image: both refuse a uniform batch
        for m, T in ((RS, RefTable), (PS, Table)):
            kw = {} if m is RS else {"device": "cpu"}
            with pytest.raises(ValueError, match="pre-batch"):
                m.ImageTransformer(stages=stages, **kw).transform(T({"image": col}))
        return
    ref = RS.ImageTransformer(stages=stages).transform(RefTable({"image": col}))
    stage = PS.ImageTransformer(stages=stages, device="cpu")
    port = stage.transform(Table({"image": col}))
    _assert_column(ref["image"], port["image"])
    stage.save(str(tmp_path / "s"))
    again = load_stage(str(tmp_path / "s")).transform(Table({"image": col}))
    _assert_column(port["image"], again["image"], 0.0)


def test_image_transformer_fixed_resize_on_ragged_input():
    col = _ragged()
    stages = [{"action": "resize", "height": 6, "width": 6},
              {"action": "threshold", "threshold": 100, "maxval": 1}]
    ref = RS.ImageTransformer(stages=stages).transform(RefTable({"image": col}))
    port = PS.ImageTransformer(stages=stages, device="cpu").transform(Table({"image": col}))
    assert port["image"].shape == (3, 6, 6, 3)
    _assert_column(ref["image"], port["image"])
    with pytest.raises(ValueError, match="unknown image action"):
        PS.ImageTransformer(stages=[{"action": "warp"}], device="cpu").transform(
            Table({"image": _images("uint8")}))


@pytest.mark.parametrize("ragged", [False, True])
def test_resize_image_transformer(ragged, tmp_path):
    col = _ragged() if ragged else _images("float32")
    ref = RS.ResizeImageTransformer(height=5, width=7).transform(RefTable({"image": col}))
    stage = PS.ResizeImageTransformer(height=5, width=7, device="cpu")
    port = stage.transform(Table({"image": col}))
    _assert_column(ref["image"], port["image"])
    stage.save(str(tmp_path / "s"))
    assert load_stage(str(tmp_path / "s")).get("height") == 5


def test_unroll_image_chw_order(tmp_path):
    x = _images("uint8", n=4, h=4, w=5)
    ref = RS.UnrollImage(output_col="feat").transform(RefTable({"image": x}))
    stage = PS.UnrollImage(output_col="feat")
    port = stage.transform(Table({"image": x}))
    _same(ref["feat"], port["feat"])
    np.testing.assert_array_equal(port["feat"][0], x[0].transpose(2, 0, 1).ravel())
    with pytest.raises(ValueError, match="uniform size"):
        stage.transform(Table({"image": _ragged()}))
    stage.save(str(tmp_path / "s"))
    _same(port["feat"], load_stage(str(tmp_path / "s")).transform(Table({"image": x}))["feat"])


@pytest.mark.parametrize("lr,ud", [(True, False), (True, True), (False, True)])
def test_image_set_augmenter(lr, ud):
    x = _images("uint8", n=4)
    cols = {"image": x, "id": np.arange(4)}
    ref = RS.ImageSetAugmenter(flip_left_right=lr, flip_up_down=ud,
                               output_col="aug").transform(RefTable(cols))
    port = PS.ImageSetAugmenter(flip_left_right=lr, flip_up_down=ud, output_col="aug",
                                device="cpu").transform(Table(cols))
    assert port.column_names == ref.column_names
    _same(ref["aug"], port["aug"])
    assert port["id"].tolist() == ref["id"].tolist()


def _png_bytes(arr):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("resize", [False, True])
def test_unroll_binary_image(resize):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(4)
    a = rng.integers(0, 255, (6, 5, 3)).astype(np.uint8)
    b = rng.integers(0, 255, (6, 5, 3) if not resize else (9, 4, 3)).astype(np.uint8)
    col = np.empty(4, dtype=object)
    col[:] = [_png_bytes(a), None, b"not an image", _png_bytes(b)]
    kw = dict(width=4, height=3) if resize else {}
    ref = RS.UnrollBinaryImage(**kw).transform(RefTable({"image": col}))
    port = PS.UnrollBinaryImage(device="cpu", **kw).transform(Table({"image": col}))
    assert port["features"][1] is None and port["features"][2] is None
    for i in (0, 3):
        _same(ref["features"][i], port["features"][i], ATOL)


def test_unroll_binary_image_param_checks():
    col = np.empty(1, dtype=object)
    col[0] = None
    with pytest.raises(ValueError, match="set together"):
        PS.UnrollBinaryImage(width=3, device="cpu").transform(Table({"image": col}))
    with pytest.raises(ValueError, match="positive"):
        PS.UnrollBinaryImage(width=0, height=2, device="cpu").transform(Table({"image": col}))


def test_stages_default_to_the_gpu():
    from synapseml_tpu_torch.runtime.device import DeviceUnavailableError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(DeviceUnavailableError):
        PS.ImageTransformer(stages=[{"action": "flip"}]).transform(
            Table({"image": _images("uint8")}))
