"""The quantized ONNX ops (kernel Q's plain version on the CPU) against the JAX
package's ops, and quantized graphs end to end.

At the op level every case is exact: MatMulInteger / QLinearMatMul in all
four signedness pairs and every zero-point form (none, scalar, per row of A,
per column of B), ConvInteger / QLinearConv over pads, strides, dilations,
groups and per-channel zero points, an int32 sum that wraps, and both
requantizing epilogues (uint8 and int8 out, with a bias). End to end,
``quantize_dynamic_graph`` of BERTTiny and of ResNet-18 hold QUANT_TOL (2e-2
of each row's norm), for the cause ROADMAP queue 3 states: the reference's
XLA program rounds some f32 values an ulp away from the IEEE result (seen
first at DynamicQuantizeLinear's scale), and a requantized activation then
crosses a rounding boundary, one quantization step.
"""

import numpy as np
import pytest

from synapseml_tpu_torch.models.zoo import bert_encoder, resnet
from synapseml_tpu_torch.onnx.wire import serialize_model
from synapseml_tpu_torch.tools.kernel_cases import (Q_CONV_CASES, Q_KINDS, Q_SIGN_PAIRS,
                                                    Q_ZP_FORMS, q_operand, q_seed,
                                                    q_zero_point)
from synapseml_tpu_torch.tools.onnx_graphs import quantize_dynamic_graph, quantized_node_counts
from torch_onnx import (QUANT_TOL, T, assert_bf16, assert_exact, assert_outputs, op_both,
                        run_both)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_KINDS = Q_KINDS
_PAIRS = Q_SIGN_PAIRS
_CONV_CASES = Q_CONV_CASES


def _rng(*parts) -> np.random.Generator:
    return np.random.default_rng(q_seed(*parts))


_q, _zp = q_operand, q_zero_point


@pytest.mark.parametrize("ka,kb", _PAIRS)
@pytest.mark.parametrize("za_form,zb_form", Q_ZP_FORMS)
def test_matmul_integer_exact(ka, kb, za_form, zb_form):
    rng = _rng(ka, kb, za_form, zb_form)
    M, K, N = 7, 37, 5
    a, b = _q(rng, (M, K), ka), _q(rng, (K, N), kb)
    ins = [T(a), T(b), _zp(rng, ka, za_form, M), _zp(rng, kb, zb_form, N)]
    while ins and ins[-1] is None:
        ins.pop()
    p, r = op_both("MatMulInteger", ins)
    assert p.dtype == np.int32
    assert_exact(p, r)


def test_matmul_integer_batched_and_broadcast():
    rng = np.random.default_rng(3)
    a, b = _q(rng, (2, 3, 6, 20), "u8"), _q(rng, (20, 4), "s8")
    p, r = op_both("MatMulInteger", [T(a), b, np.uint8(9), np.int8(-3)])
    assert p.shape == (2, 3, 6, 4)
    assert_exact(p, r)
    b3 = _q(rng, (3, 20, 4), "s8")
    p, r = op_both("MatMulInteger", [T(a), T(b3), np.uint8(9), _q(rng, (4,), "s8")])
    assert_exact(p, r)


def test_matmul_integer_int32_sum_wraps():
    """255 x 127 over 70,000 products passes 2^31: both wrap modulo 2^32."""
    K = 70_000
    a = np.full((2, K), 255, np.uint8)
    b = np.full((K, 3), 127, np.int8)
    p, r = op_both("MatMulInteger", [T(a), T(b)])
    want = np.int64(255 * 127 * K)
    assert want > 2**31 and int(p[0, 0]) == int((want + 2**31) % 2**32 - 2**31)
    assert_exact(p, r)


@pytest.mark.parametrize("case", sorted(_CONV_CASES))
@pytest.mark.parametrize("kx,kw", _PAIRS)
def test_conv_integer_exact(case, kx, kw):
    c = _CONV_CASES[case]
    rng = _rng(case, kx, kw)
    x, w = _q(rng, c["x"], kx), _q(rng, c["w"], kw)
    for w_zp in (_q(rng, (), kw), _q(rng, (c["w"][0],), kw)):
        p, r = op_both("ConvInteger", [T(x), T(w), _q(rng, (), kx), w_zp], c["attrs"])
        assert p.dtype == np.int32
        assert_exact(p, r)
    p, r = op_both("ConvInteger", [T(x), T(w)], c["attrs"])   # no zero points
    assert_exact(p, r)


@pytest.mark.parametrize("kx,kw", _PAIRS)
@pytest.mark.parametrize("ky", ["u8", "s8"])
def test_qlinear_conv_epilogue_exact(kx, kw, ky):
    rng = _rng(kx, kw, ky)
    c = _CONV_CASES["groups"]
    x, w = _q(rng, c["x"], kx), _q(rng, c["w"], kw)
    co = c["w"][0]
    bias = rng.integers(-5000, 5000, size=co).astype(np.int32)
    ins = [T(x), np.float32(0.021), _q(rng, (), kx), T(w),
           rng.uniform(0.001, 0.02, size=co).astype(np.float32), _q(rng, (co,), kw),
           np.float32(0.37), _q(rng, (), ky), bias]
    p, r = op_both("QLinearConv", ins, c["attrs"])
    assert p.dtype == _KINDS[ky]
    assert_exact(p, r)
    p, r = op_both("QLinearConv", ins[:8], c["attrs"])   # no bias
    assert_exact(p, r)


@pytest.mark.parametrize("ka,kb", _PAIRS)
@pytest.mark.parametrize("ky", ["u8", "s8"])
def test_qlinear_matmul_epilogue_exact(ka, kb, ky):
    rng = _rng(ka, kb, ky, "qlm")
    M, K, N = 6, 45, 7
    a, b = _q(rng, (M, K), ka), _q(rng, (K, N), kb)
    for per_axis in (False, True):
        a_scale = rng.uniform(0.01, 0.05, size=M if per_axis else ()).astype(np.float32)
        b_scale = rng.uniform(0.01, 0.05, size=N if per_axis else ()).astype(np.float32)
        y_scale = rng.uniform(0.5, 2.0, size=M if per_axis else ()).astype(np.float32)
        ins = [T(a), a_scale, _q(rng, (M,) if per_axis else (), ka), T(b), b_scale,
               _q(rng, (N,) if per_axis else (), kb), y_scale,
               _q(rng, (M,) if per_axis else (), ky)]
        p, r = op_both("QLinearMatMul", ins)
        assert p.dtype == _KINDS[ky]
        assert_exact(p, r)


def test_quantize_dynamic_graph_rewrites_every_weighted_matmul_and_conv():
    """The IntegerOps rewrite: one MatMulInteger per MatMul with an
    initializer weight (BERT-base: 6 a layer, the pooler and the classifier),
    one ConvInteger per Conv (ResNet-50: the stem, 48 block convs, 4
    shortcuts), one DynamicQuantizeLinear per activation."""
    # BERT-base's depth and graph (the node counts do not depend on the width)
    bert = quantized_node_counts(quantize_dynamic_graph(
        bert_encoder(layers=12, hidden=32, heads=2, vocab=50, max_seq=16)))
    assert bert["MatMulInteger"] == 12 * 6 + 2 and bert.get("MatMul") == 24
    r50 = quantized_node_counts(quantize_dynamic_graph(resnet(50)))
    assert r50["ConvInteger"] == 53 and "Conv" not in r50 and r50["Gemm"] == 1
    assert r50["DynamicQuantizeLinear"] == 53 - 4   # a shortcut shares its block's input


def test_quantized_bert_tiny_end_to_end():
    mb = serialize_model(quantize_dynamic_graph(bert_encoder(layers=2, hidden=128, heads=2,
                                                             vocab=1000, num_classes=3)))
    ids = np.random.default_rng(8).integers(0, 1000, size=(2, 16)).astype(np.int64)
    port, ref = run_both(mb, {"input_ids": ids})
    assert_outputs(port, ref, check=assert_bf16, tol=QUANT_TOL)


def test_quantized_resnet18_end_to_end():
    mb = serialize_model(quantize_dynamic_graph(resnet(18, num_classes=10)))
    x = np.random.default_rng(9).normal(size=(2, 3, 64, 64)).astype(np.float32)
    port, ref = run_both(mb, {"data": x})
    assert_outputs(port, ref, check=assert_bf16, tol=QUANT_TOL)
