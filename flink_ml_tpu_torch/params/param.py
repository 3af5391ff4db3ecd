"""Param / WithParams core.

The port's copy of ``flink_ml_tpu/params/param.py``. Reference behavior
(flink-ml-servable-core):
- param/Param.java:30 — a param is (name, type, description, defaultValue,
  validator); identity is the *name*.
- param/WithParams.java — get falls back to the default; set validates;
  getParamMap exposes every declared param (including inherited mixins).
- param/ParamValidators.java:27-113 — the validator zoo.
- util/ParamUtils.java / JsonUtils — JSON encode/decode of param maps for
  save/load and for the benchmark CLI configs.

The JSON written here is byte-for-byte what the JAX package writes for the
same params, so saved models and benchmark configs cross the two packages.
The window-valued param comes with the slice that uses it.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Generic, List, Optional, Sequence, TypeVar

T = TypeVar("T")

# word boundary before an uppercase run start, treating acronyms as one word:
# minDF → min_df, rawPredictionCol → raw_prediction_col
_CAMEL_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")


def camel_to_snake(name: str) -> str:
    return _CAMEL_RE.sub("_", name).lower()


def snake_to_camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(w.capitalize() for w in rest)


class ParamValidator(Generic[T]):
    """Validates a param value; mirrors param/ParamValidator.java."""

    def __init__(self, fn: Callable[[Any], bool], description: str = ""):
        self._fn = fn
        self.description = description

    def __call__(self, value: Any) -> bool:
        return self._fn(value)


class ParamValidators:
    """The validator factory zoo (ref: ParamValidators.java:27-113)."""

    @staticmethod
    def always_true() -> ParamValidator:
        return ParamValidator(lambda v: True, "always_true")

    @staticmethod
    def gt(lower: float) -> ParamValidator:
        return ParamValidator(lambda v: v is not None and v > lower, f"> {lower}")

    @staticmethod
    def gt_eq(lower: float) -> ParamValidator:
        return ParamValidator(lambda v: v is not None and v >= lower, f">= {lower}")

    @staticmethod
    def lt(upper: float) -> ParamValidator:
        return ParamValidator(lambda v: v is not None and v < upper, f"< {upper}")

    @staticmethod
    def lt_eq(upper: float) -> ParamValidator:
        return ParamValidator(lambda v: v is not None and v <= upper, f"<= {upper}")

    @staticmethod
    def in_range(lower: float, upper: float, lower_inclusive: bool = True,
                 upper_inclusive: bool = True) -> ParamValidator:
        def ok(v):
            if v is None:
                return False
            lo = v >= lower if lower_inclusive else v > lower
            hi = v <= upper if upper_inclusive else v < upper
            return lo and hi
        return ParamValidator(ok, f"in_range({lower}, {upper})")

    @staticmethod
    def in_array(*allowed) -> ParamValidator:
        allowed_set = set(allowed)
        return ParamValidator(lambda v: v in allowed_set, f"in {sorted(map(str, allowed_set))}")

    @staticmethod
    def not_null() -> ParamValidator:
        return ParamValidator(lambda v: v is not None, "not_null")

    @staticmethod
    def non_empty_array() -> ParamValidator:
        return ParamValidator(lambda v: v is not None and len(v) > 0, "non_empty_array")

    @staticmethod
    def is_sub_set(*allowed) -> ParamValidator:
        allowed_set = set(allowed)
        return ParamValidator(
            lambda v: v is not None and set(v).issubset(allowed_set),
            f"subset of {sorted(map(str, allowed_set))}",
        )


class Param(Generic[T]):
    """A typed, validated, JSON-serializable hyperparameter (ref: Param.java:30).

    Also acts as a Python descriptor: reading the class attribute from an
    instance returns the current value, so ``stage.max_iter`` works.
    """

    #: subclasses override for validation / json coercion
    value_type: type = object

    def __init__(self, name: str, description: str, default_value: T = None,
                 validator: Optional[ParamValidator] = None):
        self.name = name                      # camelCase, the identity key
        self.attr_name = camel_to_snake(name)  # snake_case Python-side name
        self.description = description
        self.validator = validator or ParamValidators.always_true()
        # canonicalize at declaration time so the default compares equal to
        # the same value set later (e.g. an int default on a FloatParam)
        if default_value is not None:
            default_value = self.coerce(default_value)
        self.validate(default_value, allow_none=True)
        self.default_value = default_value

    # -- descriptor protocol -------------------------------------------------
    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get(self)

    def __set__(self, obj, value):
        obj.set(self, value)

    # -- validation / codec --------------------------------------------------
    def validate(self, value: Any, allow_none: bool = False) -> None:
        if value is None and allow_none:
            return
        if not self.validator(value):
            raise ValueError(
                f"Parameter {self.name} is given an invalid value {value!r}"
                + (f" (must be {self.validator.description})" if self.validator.description else "")
            )

    def coerce(self, value: Any) -> Any:
        """Coerce a user/JSON value to the param's canonical Python type."""
        return value

    def json_encode(self, value: Any) -> Any:
        return value

    def json_decode(self, value: Any) -> Any:
        return self.coerce(value)

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r}, default={self.default_value!r})"

    # Identity is the name (ref: Param.java equals/hashCode semantics).
    def __eq__(self, other):
        return isinstance(other, Param) and other.name == self.name

    def __hash__(self):
        return hash(self.name)


class IntParam(Param[int]):
    value_type = int

    def coerce(self, value):
        return None if value is None else int(value)


class LongParam(IntParam):
    pass


class FloatParam(Param[float]):
    value_type = float

    def coerce(self, value):
        return None if value is None else float(value)


# The reference distinguishes Double/Float; Python has one float.
DoubleParam = FloatParam


class BooleanParam(Param[bool]):
    value_type = bool

    def coerce(self, value):
        return None if value is None else bool(value)


class StringParam(Param[str]):
    value_type = str


class ArrayParam(Param[Sequence]):
    """Array param; stored as a tuple so values are hashable/immutable."""

    elem_coerce: Callable = staticmethod(lambda v: v)

    def coerce(self, value):
        if value is None:
            return None
        return tuple(self.elem_coerce(v) for v in value)


class IntArrayParam(ArrayParam):
    elem_coerce = staticmethod(int)


class LongArrayParam(IntArrayParam):
    pass


class FloatArrayParam(ArrayParam):
    elem_coerce = staticmethod(float)


DoubleArrayParam = FloatArrayParam


class StringArrayParam(ArrayParam):
    elem_coerce = staticmethod(str)


class ArrayArrayParam(Param[Sequence]):
    elem_coerce: Callable = staticmethod(lambda v: v)

    def coerce(self, value):
        if value is None:
            return None
        return tuple(tuple(self.elem_coerce(x) for x in row) for row in value)


class FloatArrayArrayParam(ArrayArrayParam):
    elem_coerce = staticmethod(float)


DoubleArrayArrayParam = FloatArrayArrayParam


class StringArrayArrayParam(ArrayArrayParam):
    elem_coerce = staticmethod(str)


class VectorParam(Param):
    """Param holding a DenseVector/SparseVector (ref: VectorParam.java)."""

    def coerce(self, value):
        from flink_ml_tpu_torch.linalg.vectors import Vector, Vectors
        if value is None or isinstance(value, Vector):
            return value
        return Vectors.dense(value)

    def json_encode(self, value):
        if value is None:
            return None
        from flink_ml_tpu_torch.linalg.vectors import SparseVector
        if isinstance(value, SparseVector):
            return {"kind": "sparse", "size": int(value.size),
                    "indices": [int(i) for i in value.indices],
                    "values": [float(v) for v in value.values]}
        return {"kind": "dense", "values": [float(v) for v in value.to_array()]}

    def json_decode(self, value):
        if value is None:
            return None
        from flink_ml_tpu_torch.linalg.vectors import Vectors
        if isinstance(value, dict) and value.get("kind") == "sparse":
            return Vectors.sparse(value["size"], value["indices"], value["values"])
        if isinstance(value, dict):
            return Vectors.dense(value["values"])
        return Vectors.dense(value)


class WithParams:
    """Mixin giving a class a typed param map (ref: WithParams.java).

    Params are declared as class attributes of type :class:`Param` anywhere in
    the MRO (this is how the reference's ``Has*`` interfaces compose). Values
    live in an instance dict keyed by param name; reads fall back to defaults.
    """

    def __init__(self, **kwargs):
        self._param_map: dict = {}
        for key, value in kwargs.items():
            param = self._find_param(key)
            if param is None:
                raise ValueError(f"{type(self).__name__} has no param named {key!r}")
            self.set(param, value)

    # -- declared params -----------------------------------------------------
    # The declared-param set is fixed at class-creation time; cache per class
    # (keyed on the class object itself so subclasses don't share entries).
    _params_cache: dict = {}
    _index_cache: dict = {}

    @classmethod
    def params(cls) -> List[Param]:
        """All params declared across the MRO, in a stable order."""
        cached = WithParams._params_cache.get(cls)
        if cached is not None:
            return cached
        seen, out = set(), []
        for klass in cls.__mro__:
            for value in vars(klass).values():
                if isinstance(value, Param) and value.name not in seen:
                    seen.add(value.name)
                    out.append(value)
        WithParams._params_cache[cls] = out
        WithParams._index_cache[cls] = {
            key: p for p in out for key in (p.name, p.attr_name)}
        return out

    @classmethod
    def _find_param(cls, name: str) -> Optional[Param]:
        """Look up by camelCase param name or snake_case attribute name."""
        index = WithParams._index_cache.get(cls)
        if index is None:
            cls.params()
            index = WithParams._index_cache[cls]
        return index.get(name)

    def get_param(self, name: str) -> Param:
        p = self._find_param(name)
        if p is None:
            raise ValueError(f"{type(self).__name__} has no param named {name!r}")
        return p

    # -- get/set -------------------------------------------------------------
    def get(self, param: Param):
        if isinstance(param, str):
            param = self.get_param(param)
        if param.name in self._param_map:
            return self._param_map[param.name]
        return param.default_value

    def set(self, param: Param, value):
        if isinstance(param, str):
            param = self.get_param(param)
        if self._find_param(param.name) is None:
            raise ValueError(f"{type(self).__name__} has no param {param.name!r}")
        value = param.coerce(value)
        param.validate(value)
        self._param_map[param.name] = value
        return self

    def get_param_map(self) -> dict:
        """name → current value for every declared param (ref: getParamMap)."""
        return {p.name: self.get(p) for p in self.params()}

    # -- fluent set_x/get_x sugar (pyflink.ml API parity) --------------------
    def __getattr__(self, item):
        if item.startswith("set_"):
            param = self._find_param(item[4:])
            if param is not None:
                def setter(value, _p=param):
                    return self.set(_p, value)
                return setter
        elif item.startswith("get_"):
            param = self._find_param(item[4:])
            if param is not None:
                return lambda _p=param: self.get(_p)
        if not item.startswith("_"):
            # bare snake_case name reads the param value: stage.max_iter
            param = self._find_param(item)
            if param is not None:
                return self.get(param)
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {item!r}")

    def __setattr__(self, name, value):
        # bare snake_case name writes the param value: stage.max_iter = 5
        if not name.startswith("_") and not hasattr(type(self), name):
            param = self._find_param(name)
            if param is not None:
                self.set(param, value)
                return
        super().__setattr__(name, value)

    def copy_params_to(self, dst: "WithParams") -> "WithParams":
        """Copy every param the destination also declares (ref:
        ParamUtils.updateExistingParams — estimator→model propagation)."""
        for name, value in self.params_to_json().items():
            param = dst._find_param(name)
            if param is not None:
                dst._set_decoded(param, value)
        return dst

    def _set_decoded(self, param: Param, raw, strict: bool = False) -> None:
        """Apply one JSON-encoded value. ``null`` is an explicit None value
        when the param can legally hold None, otherwise it means "unset" and
        is left at the default — the single rule shared by params_from_json
        and copy_params_to. Under ``strict`` (the benchmark CLI contract) a
        null that the param cannot hold is a config error and raises."""
        if raw is None:
            try:
                param.validate(None)
            except ValueError:
                if strict:
                    raise
                return
            self._param_map[param.name] = None
            return
        self.set(param, param.json_decode(raw))

    # -- JSON round-trip (ref: ParamUtils + ReadWriteUtils metadata) --------
    def params_to_json(self) -> dict:
        out = {}
        for p in self.params():
            value = self.get(p)
            out[p.name] = p.json_encode(value)
        return out

    def params_from_json(self, data: dict, strict: bool = False):
        """strict=False ignores unknown names (save/load forward compat);
        strict=True raises like ParamUtils.instantiateWithParams does for
        undefined parameters (the benchmark CLI contract)."""
        for name, raw in data.items():
            param = self._find_param(name)
            if param is None:
                if strict:
                    raise ValueError(
                        f"unknown parameter {name!r} for "
                        f"{type(self).__name__}")
                continue
            self._set_decoded(param, raw, strict=strict)
        return self

    def params_to_json_str(self) -> str:
        return json.dumps(self.params_to_json(), sort_keys=True)
