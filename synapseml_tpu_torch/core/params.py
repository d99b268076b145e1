"""Typed, validated, serializable parameter system.

A copy of the JAX package's module of the same name (which imports no JAX
either); the port keeps its own copy so that it imports nothing of that package.


This is the rebuild's equivalent of SparkML ``Params`` as used throughout the
reference (``org.apache.spark.ml.param``; complex params at
``core/src/main/scala/com/microsoft/azure/synapse/ml/core/serialize/ComplexParam.scala``).
Params are *the* config system of the framework (SURVEY.md §5): they power

- typed validated configuration of every pipeline stage,
- JSON (de)serialization of stages and pipelines,
- reflection for binding codegen and the fuzzing meta-tests
  (reference: ``core/.../codegen/Wrappable.scala:68``, ``src/test/.../FuzzingTest.scala``).

Design: plain Python descriptors + an explicit per-class registry built by
``__init_subclass__`` — no metaclass magic, friendly to static analysis.
"""

from __future__ import annotations

import copy
import json
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Type

__all__ = [
    "Param",
    "ComplexParam",
    "Params",
    "ParamValidators",
    "ParamMap",
]


class ParamValidators:
    """Factory of reusable validators (reference: ``ParamValidators`` in SparkML)."""

    @staticmethod
    def gt(low) -> Callable[[Any], bool]:
        return lambda v: v > low

    @staticmethod
    def gt_eq(low) -> Callable[[Any], bool]:
        return lambda v: v >= low

    @staticmethod
    def lt(high) -> Callable[[Any], bool]:
        return lambda v: v < high

    @staticmethod
    def lt_eq(high) -> Callable[[Any], bool]:
        return lambda v: v <= high

    @staticmethod
    def in_range(low, high, low_inclusive=True, high_inclusive=True) -> Callable[[Any], bool]:
        def check(v):
            ok_low = v >= low if low_inclusive else v > low
            ok_high = v <= high if high_inclusive else v < high
            return ok_low and ok_high

        return check

    @staticmethod
    def in_list(allowed) -> Callable[[Any], bool]:
        allowed = list(allowed)
        return lambda v: v in allowed

    @staticmethod
    def array_length_gt(n) -> Callable[[Any], bool]:
        return lambda v: len(v) > n

    @staticmethod
    def non_empty() -> Callable[[Any], bool]:
        return lambda v: len(v) > 0


class Param:
    """A typed parameter attached to a :class:`Params` class.

    Acts as a descriptor: ``stage.my_param`` returns the current value (set or default),
    ``stage.my_param = v`` validates and sets. ``dtype`` is advisory (used by codegen and
    the fuzzing meta-test to generate values); ``validator`` gates every set.
    """

    # Sentinel distinguishing "no default" from "default is None".
    _NO_DEFAULT = object()

    def __init__(
        self,
        doc: str,
        dtype: type = object,
        default: Any = _NO_DEFAULT,
        validator: Optional[Callable[[Any], bool]] = None,
        *,
        is_complex: bool = False,
    ):
        self.name: str = "<unbound>"
        self.owner: Optional[type] = None
        self.doc = doc
        self.dtype = dtype
        self.default = default
        self.validator = validator
        self.is_complex = is_complex

    @property
    def has_default(self) -> bool:
        return self.default is not Param._NO_DEFAULT

    def __set_name__(self, owner, name):
        self.name = name
        self.owner = owner

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get_or_default(self.name)

    def __set__(self, obj, value):
        obj.set(self.name, value)

    def validate(self, value) -> None:
        if self.validator is not None and not self.validator(value):
            raise ValueError(
                f"Param {self.owner.__name__ if self.owner else '?'}.{self.name}: "
                f"value {value!r} failed validation ({self.doc})"
            )

    def __repr__(self):
        return f"Param({self.name}: {self.dtype.__name__}, doc={self.doc!r})"


class ComplexParam(Param):
    """Param holding a non-JSON value (arrays, fitted models, nested stages, callables).

    Reference: ``ComplexParam`` / the 21 custom param classes under
    ``core/src/main/scala/org/apache/spark/ml/param/`` (``ByteArrayParam``,
    ``TransformerParam``, ``EstimatorParam``, ``DataFrameParam``, ``UDFParam``,
    ``BallTreeParam``, ...). Serialized out-of-band by ``serialization.py`` rather than
    into the stage's JSON metadata.
    """

    def __init__(self, doc: str, dtype: type = object, default: Any = Param._NO_DEFAULT,
                 validator: Optional[Callable[[Any], bool]] = None):
        super().__init__(doc, dtype=dtype, default=default, validator=validator, is_complex=True)


ParamMap = Dict[str, Any]


class Params:
    """Base class for anything carrying :class:`Param` descriptors.

    Subclasses declare params as class attributes; ``__init_subclass__`` aggregates them
    (including inherited ones) into ``cls._params``. Constructor accepts ``**kwargs``
    addressing params by name, mirroring the generated-python-wrapper ergonomics of the
    reference (``codegen/Wrappable.scala:93``).
    """

    _params: Dict[str, Param] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        merged: Dict[str, Param] = {}
        for base in reversed(cls.__mro__):
            for k, v in vars(base).items():
                if isinstance(v, Param):
                    merged[k] = v
        cls._params = merged

    def __init__(self, uid: Optional[str] = None, **kwargs):
        # _param_values must exist before any set().
        object.__setattr__(self, "_param_values", {})
        self.uid = uid or f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self.set_params(**kwargs)

    # -- declaration / reflection ------------------------------------------------

    @classmethod
    def params(cls) -> Dict[str, Param]:
        return dict(cls._params)

    @classmethod
    def get_param(cls, name: str) -> Param:
        try:
            return cls._params[name]
        except KeyError:
            raise KeyError(f"{cls.__name__} has no param {name!r}") from None

    def has_param(self, name: str) -> bool:
        return name in self._params

    # -- get / set ---------------------------------------------------------------

    def set(self, name: str, value: Any) -> "Params":
        p = self.get_param(name)
        if value is not None:
            p.validate(value)
        self._param_values[name] = value
        return self

    def set_params(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self.set(k, v)
        return self

    def get(self, name: str) -> Any:
        self.get_param(name)
        return self._param_values[name]

    def get_or_default(self, name: str) -> Any:
        p = self.get_param(name)
        if name in self._param_values:
            return self._param_values[name]
        if p.has_default:
            # Copy mutable defaults so stages can't alias each other's lists/dicts.
            d = p.default
            return copy.copy(d) if isinstance(d, (list, dict, set)) else d
        raise KeyError(f"Param {type(self).__name__}.{name} is not set and has no default")

    def is_set(self, name: str) -> bool:
        return name in self._param_values

    def is_defined(self, name: str) -> bool:
        return self.is_set(name) or self.get_param(name).has_default

    def clear(self, name: str) -> "Params":
        self._param_values.pop(name, None)
        return self

    # -- introspection -----------------------------------------------------------

    def extract_param_map(self) -> ParamMap:
        """All defined (set or defaulted) param values."""
        out: ParamMap = {}
        for name, p in self._params.items():
            if self.is_defined(name):
                out[name] = self.get_or_default(name)
        return out

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(self._params.items()):
            cur = repr(self.get_or_default(name)) if self.is_defined(name) else "undefined"
            lines.append(f"{name}: {p.doc} (current: {cur})")
        return "\n".join(lines)

    def copy(self, extra: Optional[ParamMap] = None) -> "Params":
        """Deep-ish copy: param values are shallow-copied, complex values shared."""
        other = copy.copy(self)
        object.__setattr__(other, "_param_values", dict(self._param_values))
        if extra:
            other.set_params(**extra)
        return other

    # -- (de)serialization of simple params --------------------------------------

    def simple_param_values(self) -> ParamMap:
        return {
            k: v for k, v in self._param_values.items() if not self._params[k].is_complex
        }

    def complex_param_values(self) -> ParamMap:
        return {k: v for k, v in self._param_values.items() if self._params[k].is_complex}

    def params_to_json(self) -> str:
        return json.dumps(self.simple_param_values(), sort_keys=True, default=_json_default)

    def __repr__(self):
        vals = ", ".join(f"{k}={v!r}" for k, v in sorted(self.simple_param_values().items()))
        return f"{type(self).__name__}(uid={self.uid}, {vals})"


def _json_default(o):
    # numpy scalars sneak into params frequently; coerce them.
    try:
        import numpy as np

        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except ImportError:  # pragma: no cover
        pass
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(f"Not JSON serializable: {type(o)}")
