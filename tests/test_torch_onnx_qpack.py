"""Kernel Q's packed operands, on the CPU.

8-bit wgmma takes both operands K-major, so kernel Q reads B packed
(``onnx/qgemm.py``): a matmul's B transposed to (N, K), a conv's weight
reordered to (Cout, KH, KW, cin_p) with its channels padded to a multiple of
4, each row zero-padded to a multiple of 16 bytes, with B's sums along k;
a conv's x is written channels-last with its padded channels at x_zp. The
kernel then takes the zero-point identity

    sum_k (a - za)(b - zb) = sum ab - zb sum a - za sum b + K za zb

in uint32. Here that identity is taken in int64 over the packed operands
(and an im2col of the channels-last x in the kernel's (kh, kw, c) order),
then wrapped to int32, and must equal the plain versions (the reference's
arithmetic) bit for bit in all four signedness pairs and every zero-point
form; the op results with constant weights, which the executor packs, hold
the JAX package's exactly; and an ``OnnxFunction`` packs each weight once.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu_torch.models.zoo import bert_encoder, resnet
from synapseml_tpu_torch.onnx import qgemm
from synapseml_tpu_torch.onnx.importer import OnnxFunction
from synapseml_tpu_torch.onnx.ops import _STORE, ConstStore, _conv_geometry
from synapseml_tpu_torch.onnx.wire import serialize_model
from synapseml_tpu_torch.tools.kernel_cases import (Q_CONV_CASES, Q_SIGN_PAIRS, Q_ZP_FORMS,
                                                    q_operand, q_seed, q_zero_point)
from synapseml_tpu_torch.tools.onnx_graphs import quantize_dynamic_graph
from torch_onnx import T, assert_exact, op_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    return ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _zp64(zp, shape):
    if zp is None:
        return torch.zeros((), dtype=torch.long)
    return torch.as_tensor(zp).long().reshape(shape)


def _identity(a_rows: torch.Tensor, bt: torch.Tensor, colsum, K: int, za, zb) -> torch.Tensor:
    """The kernel's epilogue over (M, Kp) rows of A and (N, Kp) packed rows
    of B, in int64, wrapped to int32: ``za`` 0-d or (M, 1), ``zb`` 0-d or
    (N,)."""
    acc = a_rows.long() @ bt.long().T
    rows = a_rows.long().sum(-1, keepdim=True)
    return _wrap32(acc - zb * rows - za * colsum.long() + K * za * zb)


@pytest.mark.parametrize("ka,kb", Q_SIGN_PAIRS)
@pytest.mark.parametrize("za_form,zb_form", Q_ZP_FORMS)
def test_packed_matmul_identity_equals_plain(ka, kb, za_form, zb_form):
    rng = np.random.default_rng(q_seed(ka, kb, za_form, zb_form, "qpack"))
    for M, K, N in ((7, 37, 5), (33, 1, 9), (20, 160, 64), (3, 769, 2)):
        a, b = q_operand(rng, (M, K), ka), q_operand(rng, (K, N), kb)
        za, zb = q_zero_point(rng, ka, za_form, M), q_zero_point(rng, kb, zb_form, N)
        packed = qgemm.pack_matmul_b(torch.from_numpy(b))
        ldb = packed.bt.shape[-1]
        assert packed.bt.shape == (1, N, ldb) and ldb % 16 == 0 and ldb >= K
        assert packed.k == K and not packed.bt[0, :, K:].any()
        assert torch.equal(packed.bt[0, :, :K], torch.from_numpy(b).T)
        a_rows = torch.zeros((M, ldb), dtype=torch.from_numpy(a).dtype)
        a_rows[:, :K] = torch.from_numpy(a)      # the kernel's 16-byte padded A
        got = _identity(a_rows, packed.bt[0], packed.colsum[0], K,
                        _zp64(za, (-1, 1) if za_form == "row" else ()),
                        _zp64(zb, (-1,) if zb_form == "col" else ()))
        want = qgemm.qmatmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                                   None if za is None else torch.as_tensor(za),
                                   None if zb is None else torch.as_tensor(zb))
        assert torch.equal(got, want)


def test_packed_matmul_batched_b_and_wrapping_sums():
    """A batch of B's (packed a call for a B computed in the graph) and a sum
    past 2^31 that wraps modulo 2^32 as the reference's int32 sum does."""
    rng = np.random.default_rng(q_seed("qpack-batched"))
    b3 = torch.from_numpy(q_operand(rng, (3, 48, 4), "s8"))
    packed = qgemm.pack_matmul_b(b3)
    assert packed.bt.shape == (3, 4, 48) and packed.colsum.shape == (3, 4)
    a = torch.from_numpy(q_operand(rng, (3, 6, 48), "u8"))
    za, zb = torch.tensor(9).long(), torch.tensor(-3).long()
    for z in range(3):
        got = _identity(a[z], packed.bt[z], packed.colsum[z], 48, za, zb)
        want = qgemm.qmatmul_plain(a[z], b3[z], torch.tensor(9, dtype=torch.uint8),
                                   torch.tensor(-3, dtype=torch.int8))
        assert torch.equal(got, want)
    K = 70_000
    a = torch.full((2, K), 255, dtype=torch.uint8)
    b = torch.full((K, 3), 127, dtype=torch.int8)
    packed = qgemm.pack_matmul_b(b)
    got = _identity(a, packed.bt[0, :, :K], packed.colsum[0], K, torch.tensor(0),
                    torch.tensor(0))
    assert torch.equal(got, qgemm.qmatmul_plain(a, b))


def _im2col(xcl: torch.Tensor, x_zp, KH, KW, strides, pads, dilations, OH, OW):
    """(groups, images x OH x OW, KH x KW x cin_p) rows of the channels-last
    x in the kernel's (kh, kw, c) order, a padded tap at x_zp's raw value."""
    n, groups, H, W, cin_p = xcl.shape
    fill = 0 if x_zp is None else int(torch.as_tensor(x_zp))
    xp = torch.full((n, groups, H + sum(pads[0]), W + sum(pads[1]), cin_p), fill,
                    dtype=torch.int64)
    xp[:, :, pads[0][0]:pads[0][0] + H, pads[1][0]:pads[1][0] + W] = xcl.long()
    taps = [xp[:, :, kh * dilations[0]:kh * dilations[0] + strides[0] * (OH - 1) + 1:strides[0],
               kw * dilations[1]:kw * dilations[1] + strides[1] * (OW - 1) + 1:strides[1]]
            for kh in range(KH) for kw in range(KW)]
    cols = torch.stack(taps, dim=4)                    # (n, g, OH, OW, taps, cin_p)
    return cols.permute(1, 0, 2, 3, 4, 5).reshape(groups, n * OH * OW, -1)


@pytest.mark.parametrize("kx,kw", Q_SIGN_PAIRS)
@pytest.mark.parametrize("case", sorted(Q_CONV_CASES))
def test_packed_conv_identity_equals_plain(case, kx, kw):
    c = Q_CONV_CASES[case]
    rng = np.random.default_rng(q_seed(case, kx, kw, "qpack"))
    x = torch.from_numpy(q_operand(rng, c["x"], kx))
    w = torch.from_numpy(q_operand(rng, c["w"], kw))
    strides, pads, dilations, groups = _conv_geometry(c["attrs"], x.shape, w.shape)
    packed = qgemm.pack_conv_w(w)
    cout = w.shape[0]
    assert packed.cin_p % 4 == 0 and packed.bt.shape[-1] % 16 == 0
    assert torch.equal(packed.colsum, w.long().sum(dim=tuple(range(1, w.dim()))).int())
    x4, w4 = (x[:, :, None], w[:, :, None]) if x.dim() == 3 else (x, w)
    if x.dim() == 3:
        strides, pads, dilations = (1, strides[0]), ((0, 0), tuple(pads[0])), (1, dilations[0])
    _, _, KH, KW = w4.shape
    OH = (x4.shape[2] + sum(pads[0]) - dilations[0] * (KH - 1) - 1) // strides[0] + 1
    OW = (x4.shape[3] + sum(pads[1]) - dilations[1] * (KW - 1) - 1) // strides[1] + 1
    for x_zp, w_zp in ((None, None), (q_operand(rng, (), kx), q_operand(rng, (), kw)),
                       (q_operand(rng, (), kx), q_operand(rng, (cout,), kw))):
        xz = None if x_zp is None else torch.as_tensor(x_zp)
        xcl = qgemm.channels_last(x4, groups, packed.cin_p, xz)
        cols = _im2col(xcl, xz, KH, KW, strides, pads, dilations, OH, OW)
        cg = cout // groups
        za = _zp64(x_zp, ())
        outs = []
        for g in range(groups):
            rows = slice(g * cg, (g + 1) * cg)
            zb = _zp64(w_zp, ()) if w_zp is None or np.ndim(w_zp) == 0 else \
                torch.as_tensor(w_zp).long()[rows]
            outs.append(_identity(cols[g], packed.bt[rows, :packed.k], packed.colsum[rows],
                                  packed.k, za, zb))
        got = torch.cat(outs, dim=1).reshape(x4.shape[0], OH, OW, cout).permute(0, 3, 1, 2)
        want = qgemm.qconv_plain(x, w, xz, None if w_zp is None else torch.as_tensor(w_zp),
                                 strides if x.dim() == 4 else strides[1:],
                                 pads if x.dim() == 4 else pads[1:],
                                 dilations if x.dim() == 4 else dilations[1:], groups)
        assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("ka,kb", Q_SIGN_PAIRS)
def test_executor_packs_constant_weights_and_ops_hold_the_reference(ka, kb):
    """MatMulInteger and ConvInteger with constant weights, run as the
    executor runs them (its store packs the weight, once), against the JAX
    package's ops, exactly; a zero-point initializer of zeros gives the same
    result as none."""
    rng = np.random.default_rng(q_seed(ka, kb, "qpack-ops"))
    a, b = q_operand(rng, (2, 5, 40), ka), q_operand(rng, (40, 24), kb)
    x, w = q_operand(rng, (2, 8, 7, 7), ka), q_operand(rng, (6, 4, 3, 3), kb)
    zb0 = np.zeros((), b.dtype)
    store = ConstStore()
    for const in (b, w, zb0):
        store.add(const)
    token = _STORE.set(store)
    try:
        for zb in (zb0, q_operand(rng, (24,), kb)):
            p, r = op_both("MatMulInteger", [T(a), b, q_operand(rng, (), ka), zb])
            assert_exact(p, r)
        p, r = op_both("ConvInteger", [T(x), w, q_operand(rng, (), ka), zb0],
                       {"group": 2, "pads": [1, 1, 1, 1]})
        assert_exact(p, r)
        assert store.packs == 2   # b and w, each once
    finally:
        _STORE.reset(token)


def _weight_names(model, op_type):
    inits = {t.name for t in model.graph.initializer}
    return {n.input[1] for n in model.graph.node if n.op_type == op_type and n.input[1] in inits}


@pytest.mark.parametrize("which", ["bert", "resnet"])
def test_onnx_function_packs_each_weight_once(which):
    """quantize_dynamic_graph of a small BERT and ResNet-18: the first call
    packs every MatMulInteger / ConvInteger weight once; later calls, and a
    new input-shape signature (a new plan), pack nothing again."""
    rng = np.random.default_rng(5)
    if which == "bert":
        model = quantize_dynamic_graph(bert_encoder(layers=2, hidden=32, heads=2, vocab=50))
        op, feeds = "MatMulInteger", [{"input_ids": rng.integers(0, 50, (2, 8))},
                                      {"input_ids": rng.integers(0, 50, (3, 5))}]
    else:
        model = quantize_dynamic_graph(resnet(18, num_classes=10))
        op, feeds = "ConvInteger", [
            {"data": rng.normal(size=(1, 3, 32, 32)).astype(np.float32)},
            {"data": rng.normal(size=(1, 3, 40, 40)).astype(np.float32)}]
    n_weights = len(_weight_names(model, op))
    assert n_weights > 0
    fn = OnnxFunction(serialize_model(model), device="cpu")
    fn(feeds[0])
    assert fn._store.packs == n_weights
    fn(feeds[0])
    fn(feeds[1])
    assert len(fn._plans) == 2 and fn._store.packs == n_weights
