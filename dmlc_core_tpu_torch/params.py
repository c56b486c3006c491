"""Parameter reflection module.

A copy of ``dmlc_core_tpu/params.py`` in the port. Equivalent of
reference ``include/dmlc/parameter.h`` (1153 L):
``DMLC_DECLARE_PARAMETER / DMLC_DECLARE_FIELD`` CRTP reflection over plain
structs (parameter.h:286-319), keyword init with unknown/strict matching modes
(parameter.h:77-84, 429-482), per-field range / lower-bound / enum validation
(parameter.h:775-880), docstring generation (PrintDocString, parameter.h:541),
and JSON save/load (parameter.h:211-223).

In Python the natural idiom is a declarative field-descriptor class::

    class CSVParserParam(Parameter):
        format = field(str, default="csv", desc="File format")
        label_column = field(int, default=-1, lower_bound=-1)

    p = CSVParserParam()
    unknown = p.init({"label_column": "0", "foo": "1"}, allow_unknown=True)

String values are coerced to the declared type (URI query args arrive as
strings, mirroring how URISpec.args flow into ``param_.Init`` in the reference
parsers, csv_parser.h:230-236).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Type

from dmlc_core_tpu_torch.base import DMLCError

__all__ = ["Parameter", "ParamError", "field", "Field"]


class ParamError(DMLCError):
    """Raised on unknown/missing/invalid parameter values (parameter.h:482)."""


def _parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"invalid boolean value {s!r}")


class Field:
    """One declared parameter field — reference ``FieldEntry<T>``.

    Supports ``set_default`` (default=), ``set_range`` (range=), set_lower_bound
    (lower_bound=), ``add_enum`` (enum=) semantics of parameter.h:775-880.
    """

    __slots__ = ("name", "type", "default", "has_default", "desc", "range",
                 "lower_bound", "upper_bound", "enum", "aliases")

    def __init__(self, type_: Type, default: Any = ...,
                 desc: str = "",
                 range: Optional[Tuple[Any, Any]] = None,
                 lower_bound: Any = None,
                 upper_bound: Any = None,
                 enum: Optional[Sequence[Any]] = None,
                 aliases: Iterable[str] = ()):
        self.name = ""  # set by ParameterMeta
        self.type = type_
        self.default = default
        self.has_default = default is not ...
        self.desc = desc
        self.range = range
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.enum = list(enum) if enum is not None else None
        self.aliases = list(aliases)

    def coerce(self, value: Any) -> Any:
        """Convert `value` to the field's type (strings parse per type, bools
        accept 1/0/true/false)."""
        if isinstance(value, str) and self.type is not str:
            try:
                if self.type is bool:
                    value = _parse_bool(value)
                else:
                    value = self.type(value)
            except ValueError as e:
                raise ParamError(
                    f"Invalid value {value!r} for parameter {self.name!r} "
                    f"of type {self.type.__name__}: {e}") from None
        elif self.type is float and isinstance(value, int):
            value = float(value)
        elif not isinstance(value, self.type):
            raise ParamError(
                f"Invalid value {value!r} for parameter {self.name!r}: "
                f"expected {self.type.__name__}")
        self.validate(value)
        return value

    def validate(self, value: Any) -> None:
        """Raise ParamError when `value` violates the range/enum constraints."""
        if self.range is not None:
            lo, hi = self.range
            if not (lo <= value < hi):
                raise ParamError(
                    f"Parameter {self.name!r}={value!r} out of range [{lo}, {hi})")
        if self.lower_bound is not None and value < self.lower_bound:
            raise ParamError(
                f"Parameter {self.name!r}={value!r} below lower bound "
                f"{self.lower_bound!r}")
        if self.upper_bound is not None and value > self.upper_bound:
            raise ParamError(
                f"Parameter {self.name!r}={value!r} above upper bound "
                f"{self.upper_bound!r}")
        if self.enum is not None and value not in self.enum:
            raise ParamError(
                f"Parameter {self.name!r}={value!r} not in allowed set "
                f"{self.enum!r}")

    def doc(self) -> str:
        """One-line rendered documentation (name, type, default, range,
        choices)."""
        parts = [f"{self.name} : {self.type.__name__}"]
        if self.has_default:
            parts.append(f"(default={self.default!r})")
        if self.range is not None:
            parts.append(f"range=[{self.range[0]}, {self.range[1]})")
        if self.enum is not None:
            parts.append(f"choices={self.enum!r}")
        head = ", ".join(parts)
        return f"{head}\n    {self.desc}" if self.desc else head


def field(type_: Type, default: Any = ..., desc: str = "",
          range: Optional[Tuple[Any, Any]] = None,
          lower_bound: Any = None, upper_bound: Any = None,
          enum: Optional[Sequence[Any]] = None,
          aliases: Iterable[str] = ()) -> Field:
    """Declare a parameter field — reference ``DMLC_DECLARE_FIELD``."""
    return Field(type_, default, desc, range, lower_bound, upper_bound, enum,
                 aliases)


class ParameterMeta(type):
    def __new__(mcls, name, bases, ns):
        fields: Dict[str, Field] = {}
        for base in bases:
            fields.update(getattr(base, "__param_fields__", {}))
        for key, val in list(ns.items()):
            if isinstance(val, Field):
                val.name = key
                fields[key] = val
                del ns[key]
        ns["__param_fields__"] = fields
        alias_map: Dict[str, str] = {}
        for f in fields.values():
            for a in f.aliases:
                alias_map[a] = f.name
        ns["__param_aliases__"] = alias_map
        return super().__new__(mcls, name, bases, ns)


class Parameter(metaclass=ParameterMeta):
    """Declarative parameter struct — reference ``dmlc::Parameter<PType>``."""

    __param_fields__: Dict[str, Field] = {}
    __param_aliases__: Dict[str, str] = {}

    def __init__(self, **kwargs: Any):
        for f in self.__param_fields__.values():
            if f.has_default:
                object.__setattr__(self, f.name, f.default)
        if kwargs:
            self.init(kwargs)

    # -- reference Parameter::Init (parameter.h:140-147, 429-482) -------------
    def init(self, kwargs: Dict[str, Any], allow_unknown: bool = False
             ) -> Dict[str, Any]:
        """Initialise from a kwargs dict, validating every field.

        Returns the dict of unknown kwargs when ``allow_unknown`` (the
        kAllowUnknown mode, parameter.h:77-84); raises :class:`ParamError`
        otherwise. Missing fields without defaults raise, listing the full
        docstring like the reference's ParamError path (parameter.h:482).
        """
        fields = self.__param_fields__
        aliases = self.__param_aliases__
        unknown: Dict[str, Any] = {}
        seen = set()
        for key, value in kwargs.items():
            name = aliases.get(key, key)
            f = fields.get(name)
            if f is None:
                if allow_unknown:
                    unknown[key] = value
                    continue
                raise ParamError(
                    f"Unknown parameter {key!r}.\n"
                    f"Candidates:\n{self.docstring()}")
            object.__setattr__(self, name, f.coerce(value))
            seen.add(name)
        missing = [f.name for f in fields.values()
                   if not f.has_default and f.name not in seen]
        if missing:
            raise ParamError(
                f"Required parameters missing: {missing}.\n"
                f"Candidates:\n{self.docstring()}")
        return unknown

    def update_dict(self, kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Init + write back normalized values — reference UpdateDict."""
        unknown = self.init(dict(kwargs), allow_unknown=True)
        kwargs.update(self.as_dict())
        return unknown

    # -- reflection -----------------------------------------------------------
    @classmethod
    def fields(cls) -> List[Field]:
        """Reference ``__FIELDS__`` (parameter.h:311-319)."""
        return list(cls.__param_fields__.values())

    @classmethod
    def docstring(cls) -> str:
        """Reference ``__DOC__`` / PrintDocString (parameter.h:541)."""
        return "\n".join(f.doc() for f in cls.__param_fields__.values())

    def as_dict(self) -> Dict[str, Any]:
        """Current field values as a plain dict."""
        return {f.name: getattr(self, f.name)
                for f in self.__param_fields__.values()
                if hasattr(self, f.name)}

    # -- serialization (parameter.h:211-223) ----------------------------------
    def save_json(self) -> str:
        """Serialize current field values to a JSON string."""
        return json.dumps(self.as_dict(), sort_keys=True)

    def load_json(self, s: str) -> None:
        """Restore field values from a save_json() string."""
        self.init(json.loads(s), allow_unknown=False)

    def __setattr__(self, name: str, value: Any) -> None:
        f = self.__param_fields__.get(name)
        if f is not None:
            value = f.coerce(value)
        object.__setattr__(self, name, value)

    def __repr__(self) -> str:
        kv = ", ".join(f"{k}={v!r}" for k, v in self.as_dict().items())
        return f"{type(self).__name__}({kv})"
