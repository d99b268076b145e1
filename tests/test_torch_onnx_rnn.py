"""LSTM and GRU (kernel R's plain version on the CPU) against the JAX
package's, through whole graphs from ``tools/onnx_graphs.recurrent_graph``:
peepholes, clip, every activation, ``linear_before_reset`` 0 and 1, initial
states, under the f32 and the bf16 policy; and the reference's refusals.

Under the bf16 policy a recurrence compounds its roundings over the steps,
and the two packages round at different places (the port after every op of
the step as written; XLA keeps some intermediates of its fused step in f32):
each lands about 1 % of a row's norm from the f32 result, in its own
direction. So the port's bf16 run is held within BF16_TOL of the
reference's f32 run, and within twice that of its bf16 run (ROADMAP queue 3).
"""

import numpy as np
import pytest

from synapseml_tpu_torch.onnx.wire import serialize_model
from synapseml_tpu_torch.tools.onnx_graphs import recurrent_graph
from torch_onnx import BF16_TOL, T, assert_bf16, assert_f32, assert_outputs, op_both, run_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

S, B, I, H = 6, 3, 5, 8
_X = np.random.default_rng(21).normal(size=(S, B, I)).astype(np.float32)


def _check_both(mb, policy):
    port, ref = run_both(mb, {"x": _X}, dtype_policy=policy)
    if policy == "float32":
        assert_outputs(port, ref)
    else:
        _, ref32 = run_both(mb, {"x": _X})
        assert_outputs(port, ref32, check=assert_bf16)
        assert_outputs(port, ref, check=assert_bf16, tol=2 * BF16_TOL)
    return port


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("peepholes,clip,initial_state", [(False, None, False),
                                                          (True, None, True),
                                                          (True, 1.5, False),
                                                          (False, 0.75, True)])
def test_lstm_matches_reference(policy, peepholes, clip, initial_state):
    mb = serialize_model(recurrent_graph("LSTM", S, B, I, H, seed=1, peepholes=peepholes,
                                         clip=clip, initial_state=initial_state))
    port = _check_both(mb, policy)
    assert port["y"].shape == (S, 1, B, H) and port["y_c"].shape == (1, B, H)


@pytest.mark.parametrize("acts", [["Relu", "Sigmoid", "Tanh"], ["Tanh", "Relu", "Sigmoid"],
                                  ["Sigmoid", "Sigmoid", "Relu"]])
def test_lstm_activations_match_reference(acts):
    mb = serialize_model(recurrent_graph("LSTM", S, B, I, H, seed=2, peepholes=True, clip=3.0,
                                         activations=acts))
    port, ref = run_both(mb, {"x": _X})
    assert_outputs(port, ref)


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("lbr", [0, 1])
@pytest.mark.parametrize("clip,initial_state,bias", [(None, False, True), (2.0, True, True),
                                                     (None, True, False)])
def test_gru_matches_reference(policy, lbr, clip, initial_state, bias):
    mb = serialize_model(recurrent_graph("GRU", S, B, I, H, seed=3, clip=clip,
                                         linear_before_reset=lbr, initial_state=initial_state,
                                         bias=bias))
    port = _check_both(mb, policy)
    assert port["y"].shape == (S, 1, B, H) and port["y_h"].shape == (1, B, H)


@pytest.mark.parametrize("acts", [["Relu", "Tanh"], ["Tanh", "Sigmoid"], ["Sigmoid", "Relu"]])
@pytest.mark.parametrize("lbr", [0, 1])
def test_gru_activations_match_reference(acts, lbr):
    mb = serialize_model(recurrent_graph("GRU", S, B, I, H, seed=4, activations=acts,
                                         linear_before_reset=lbr, initial_state=True))
    port, ref = run_both(mb, {"x": _X})
    assert_outputs(port, ref)


@pytest.mark.parametrize("attrs,seq_lens,match", [
    ({"layout": 1}, None, "layout=1"),
    ({"direction": "reverse"}, None, "direction"),
    ({"direction": "bidirectional"}, None, "direction"),
    ({}, np.array([S, S - 1, S], np.int32), "ragged"),
])
@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_recurrent_refusals_match_reference(kind, attrs, seq_lens, match):
    import jax.numpy as jnp
    import torch

    from synapseml_tpu.onnx.ops import OPS as REF_OPS
    from synapseml_tpu_torch.onnx.ops import OPS

    g = 4 if kind == "LSTM" else 3
    rng = np.random.default_rng(5)
    w = rng.normal(size=(1, g * H, I)).astype(np.float32)
    r = rng.normal(size=(1, g * H, H)).astype(np.float32)
    ctx = {"op_type": kind, "opset": 17}
    for ops, x in ((OPS, torch.from_numpy(_X)), (REF_OPS, jnp.asarray(_X))):
        with pytest.raises(NotImplementedError, match=match):
            ops[kind]([x, w, r, None, seq_lens], {"hidden_size": H, **attrs}, dict(ctx))


def test_recurrent_full_length_sequence_lens_accepted():
    g, rng = 4, np.random.default_rng(6)
    w = rng.normal(size=(1, g * H, I)).astype(np.float32)
    r = rng.normal(size=(1, g * H, H)).astype(np.float32)
    (y, y_h, y_c), ref = op_both("LSTM", [T(_X), w, r, None, np.full(B, S, np.int32)],
                                 {"hidden_size": H})
    for a, b in zip((y, y_h, y_c), ref):
        assert_f32(a, b)


# -- kernel R's entries: the plan that picks one by shape ---------------------------------------

H100 = (132, 232448)   # SMs, shared memory a block may opt in to


@pytest.mark.parametrize("kind,lbr,bf16,H,want", [
    (0, 0, False, 1024, 8), (0, 0, True, 1024, 8), (1, 1, False, 1024, 8),
    (1, 0, False, 1024, 8), (0, 0, False, 1056, 8), (0, 0, False, 1064, None),
    (0, 0, False, 2048, None), (0, 0, False, 1020, None), (0, 0, False, 8, 1),
    (1, 0, True, 1536, 12), (1, 0, True, 1544, None), (1, 1, False, 1320, None)])
def test_rnn_plan_picks_the_entry_by_shape(kind, lbr, bf16, H, want):
    """The persistent entry takes a shape where H is a multiple of 8, J =
    ceil(H / SMs) units a block keep a product's rows at 32 or fewer, and
    the block's R rows, partial sums and state fit its shared memory; else
    None (the one-launch-a-step entry)."""
    from synapseml_tpu_torch.onnx.rnn import rnn_plan

    assert rnn_plan(kind, lbr, bf16, 64, H, *H100) == want


def test_rnn_plan_mirrors_the_kernel_source():
    """rnn.py's copy of the persistent entry's constants and of its shared
    memory plan (p_layout) holds the values csrc/rnn_step.cu has."""
    import re

    from synapseml_tpu_torch.kernels.build import CSRC_DIR
    from synapseml_tpu_torch.onnx import rnn

    src = (CSRC_DIR / "rnn_step.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (const("kPB"), const("kPRows"), const("kHBufs")) == \
        (rnn.P_BATCH_ROWS, rnn.P_ROWS, rnn.P_H_BUFS)
    assert rnn.P_PART_LD == rnn.P_ROWS + 4 and "kPartLd = kPRows + 4" in src
    assert "p_kt(int bf16) { return bf16 ? 256 : 64; }" in src
    assert "p_ldh(int bf16) { return bf16 ? 264 : 68; }" in src
    # GNMT's width in f32: 33 rows of R (4 x 8 and the zero row) at a row
    # stride of 1,028 floats, the 8 warps' partial sums, the cell state
    assert rnn._p_bytes(0, 0, False, 64, 1024, 8) == 33 * 1028 * 4 + 8 * 64 * 36 * 4 + 64 * 8 * 4
