"""Run ONNX graphs and ops through both packages on the CPU, and compare.

``run_both(model_bytes, feeds, **kw)`` gives each output of the JAX
package's ``OnnxFunction`` and of the port's (``device="cpu"``) as numpy.
``op_both(op_type, inputs, attrs)`` calls one op of both registries; an input
wrapped in :class:`T` is a computed value (a jnp array for the reference, a
torch tensor for the port), a bare numpy value a graph constant.

The tolerances (ROADMAP queue 3 states the looser ones' causes):
``assert_f32`` within 1e-4 of the reference relative to each output's
max-abs; ``assert_bf16`` within 2e-2 relative to each row's norm (a row: the
last axis); ``assert_exact`` equal values (the reference's int64 values come
back int32, the port's stay int64); quantized graphs end to end within
QUANT_TOL of each row's norm.
"""

import numpy as np
import torch

F32_TOL = 1e-4
BF16_TOL = 2e-2
QUANT_TOL = 2e-2   # quantized graphs end to end, row norms (ROADMAP queue 3)


class T:
    """A computed (non-constant) op input."""

    def __init__(self, a):
        self.a = np.asarray(a)


def _np(v):
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
    return np.asarray(v)


def run_both(model_bytes, feeds, **kw):
    from synapseml_tpu.onnx.importer import OnnxFunction as RefFunction
    from synapseml_tpu_torch.onnx.importer import OnnxFunction

    port = OnnxFunction(model_bytes, device="cpu", **kw)(feeds)
    ref = RefFunction(model_bytes, **kw)(feeds)
    return {k: _np(v) for k, v in port.items()}, {k: _np(v) for k, v in ref.items()}


def op_both(op_type, inputs, attrs=None, opset=17, **ctx):
    import jax.numpy as jnp

    from synapseml_tpu.onnx.ops import OPS as REF_OPS
    from synapseml_tpu_torch.onnx.ops import OPS

    attrs = attrs or {}
    base = {"op_type": op_type, "opset": opset, **ctx}
    ref_in = [jnp.asarray(v.a) if isinstance(v, T) else v for v in inputs]
    port_in = [torch.from_numpy(np.array(v.a)) if isinstance(v, T) else v for v in inputs]
    out_p = OPS[op_type](port_in, attrs, dict(base))
    out_r = REF_OPS[op_type](ref_in, attrs, dict(base))
    if isinstance(out_p, tuple):
        return tuple(_np(v) for v in out_p), tuple(_np(v) for v in out_r)
    return _np(out_p), _np(out_r)


def assert_f32(port, ref, tol=F32_TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-30)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"max|port - ref| = {err:.3g} > {tol} x {scale:.3g}"


def assert_bf16(port, ref, tol=BF16_TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    p, r = port.reshape(-1, port.shape[-1] if port.ndim else 1), \
        ref.reshape(-1, ref.shape[-1] if ref.ndim else 1)
    err = np.linalg.norm(p - r, axis=1)
    norm = np.maximum(np.linalg.norm(r, axis=1), 1e-30)
    worst = float((err / norm).max()) if len(err) else 0.0
    assert worst <= tol, f"row error {worst:.3g} > {tol}"


def assert_exact(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_array_equal(port.astype(np.float64) if port.dtype.kind == "f" else port,
                                  ref.astype(np.float64) if ref.dtype.kind == "f" else ref)


def assert_outputs(port: dict, ref: dict, check=assert_f32, **kw):
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for k in ref:
        check(port[k], ref[k], **kw)
