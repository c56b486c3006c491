"""``key = value`` text config parser.

A copy of ``dmlc_core_tpu/config.py`` in the port. Equivalent of
reference ``include/dmlc/config.h`` +
``src/config.cc`` (465 L): a tokenizer recognising bare tokens, ``=``,
double-quoted strings with ``\\"`` escapes, and ``#`` line comments
(config.cc Tokenizer), an insertion-ordered key/value store with optional
multi-value mode (``Config(multi_value=True)`` keeps every occurrence of a
repeated key; single-value mode keeps the last), and protobuf-text output
(``ToProtoString``, config.cc:59-88).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from dmlc_core_tpu_torch.base import DMLCError

__all__ = ["Config", "ConfigError"]


class ConfigError(DMLCError):
    """Malformed config input (reference Config parse errors)."""
    pass


def _tokenize(text: str) -> Iterator[Tuple[str, bool]]:
    """Yield (token, is_string) — mirrors the reference Tokenizer states."""
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in " \t\r\n":
            i += 1
        elif ch == "#":
            while i < n and text[i] not in "\r\n":
                i += 1
        elif ch == '"':
            i += 1
            buf: List[str] = []
            while True:
                if i >= n or text[i] in "\r\n":
                    raise ConfigError("quotation mark is not closed")
                if text[i] == '"':
                    i += 1
                    break
                if text[i] == "\\":
                    if i + 1 < n and text[i + 1] == '"':
                        buf.append('"')
                        i += 2
                    else:
                        raise ConfigError("error parsing escape characters")
                else:
                    buf.append(text[i])
                    i += 1
            yield "".join(buf), True
        elif ch == "=":
            i += 1
            yield "=", False
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n="#':
                j += 1
            yield text[i:j], False
            i = j


class Config:
    """Insertion-ordered config store — reference ``dmlc::Config`` (config.h:40)."""

    def __init__(self, source: str = "", multi_value: bool = False):
        self.multi_value = multi_value
        # each entry: (key, value, is_string); single-value mode updates in place
        self._order: List[Tuple[str, int]] = []
        self._values: List[Tuple[str, bool]] = []
        self._index: Dict[str, int] = {}  # key -> last value index
        if source:
            self.load(source)

    def clear(self) -> None:
        """Drop every stored entry (multi-value keys included)."""
        self._order.clear()
        self._values.clear()
        self._index.clear()

    def load(self, text: str) -> None:
        """Parse ``key = value`` lines (whitespace-insensitive token stream)."""
        toks = list(_tokenize(text))
        i = 0
        while i < len(toks):
            if i + 2 > len(toks) - 1:
                raise ConfigError(f"config: dangling tokens {toks[i:]}")
            key, key_is_str = toks[i]
            eq, eq_is_str = toks[i + 1]
            value, val_is_str = toks[i + 2]
            # a quoted "=" is a string token, not the assignment operator
            if (eq != "=" or eq_is_str or (key == "=" and not key_is_str)
                    or (value == "=" and not val_is_str)):
                raise ConfigError(
                    f"config: expected 'key = value' near {key!r}")
            self._insert(key, value, val_is_str)
            i += 3

    def _insert(self, key: str, value: str, is_string: bool) -> None:
        if not self.multi_value and key in self._index:
            vi = self._index[key]
            self._values[vi] = (value, is_string)
            return
        vi = len(self._values)
        self._values.append((value, is_string))
        self._index[key] = vi
        self._order.append((key, vi))

    def set_param(self, key: str, value, is_string: bool = False) -> None:
        """Reference ``Config::SetParam`` (config.h:81)."""
        if isinstance(value, bool):
            value = int(value)
        self._insert(key, str(value), is_string or isinstance(value, str))

    def get_param(self, key: str) -> str:
        """Reference ``Config::GetParam`` — latest value for ``key``."""
        if key not in self._index:
            raise ConfigError(f"config: key {key!r} not found")
        return self._values[self._index[key]][0]

    def items(self) -> Iterator[Tuple[str, str]]:
        """Iterate (key, value) in insertion order (ConfigIterator)."""
        for key, vi in self._order:
            yield key, self._values[vi][0]

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        return self.items()

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def to_proto_string(self) -> str:
        """Reference ``Config::ToProtoString`` (config.cc:59-88)."""
        out: List[str] = []
        for key, vi in self._order:
            value, is_string = self._values[vi]
            if is_string:
                esc = value.replace('"', '\\"')
                out.append(f'{key} : "{esc}"\n')
            else:
                out.append(f"{key} : {value}\n")
        return "".join(out)
