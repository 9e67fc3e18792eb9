"""YAML config reading and writing without PyYAML.

The port runs where PyYAML is not installed, so this module reads the
block-style YAML subset that the repository's configs and checkpoint
sidecars use: nested block mappings and sequences (a sequence may sit at
the indentation of its parent key), one-line flow sequences ``[a, b]`` and
flow mappings ``{k: v}``, single- and double-quoted strings, ``#``
comments, and plain scalars resolved as PyYAML's ``safe_load`` resolves
them (null, bool, int, float, else str).  Anchors, tags, multi-line flow
collections, block scalars (``|``, ``>``) and multiple documents are not
part of the subset and raise ``ValueError``.  :func:`save_yaml` writes
nested dicts, lists and scalars in that subset, laid out as PyYAML's
``safe_dump`` lays them out, so a sidecar the port writes reads back the
same through this reader and through PyYAML.  :func:`makedirs` is the
CLIs' check of an output directory.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Tuple

# Plain-scalar resolution, after PyYAML's YAML 1.1 implicit resolvers.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_BOOL_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_UNSUPPORTED_START = ("&", "*", "!", "|", ">", "%", "@", "`")


def _plain_scalar(text: str) -> Any:
    if _NULL.match(text):
        return None
    if _BOOL_TRUE.match(text):
        return True
    if _BOOL_FALSE.match(text):
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    if text.startswith(_UNSUPPORTED_START):
        raise ValueError(f"YAML feature outside the supported subset: {text!r}")
    return text


_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0",
            "r": "\r"}


def _quoted(text: str, pos: int) -> Tuple[str, int]:
    """Parse a quoted scalar starting at ``text[pos]``; returns (str, end)."""
    quote = text[pos]
    out = []
    i = pos + 1
    while i < len(text):
        c = text[i]
        if quote == "'" and c == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            esc = text[i + 1 : i + 2]
            if esc not in _ESCAPES:
                raise ValueError(f"unsupported escape \\{esc} in {text!r}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted scalar in {text!r}")


def _strip_comment(line: str) -> str:
    """Drop a trailing ``# comment`` that lies outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """Recursive-descent parser for one-line flow collections and scalars."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def value(self, in_flow: bool) -> Any:
        self._skip()
        c = self.text[self.pos : self.pos + 1]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in ("'", '"'):
            s, self.pos = _quoted(self.text, self.pos)
            return s
        return _plain_scalar(self._plain(in_flow, key=False))

    def _plain(self, in_flow: bool, key: bool) -> str:
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if in_flow and c in ",]}":
                break
            if key and c == ":" and self.text[self.pos + 1 : self.pos + 2] in ("", " "):
                break
            self.pos += 1
        return self.text[start : self.pos].strip()

    def _expect(self, c: str):
        self._skip()
        if self.text[self.pos : self.pos + 1] != c:
            raise ValueError(f"expected {c!r} at {self.pos} in {self.text!r}")
        self.pos += 1

    def _seq(self) -> List[Any]:
        self._expect("[")
        out: List[Any] = []
        self._skip()
        if self.text[self.pos : self.pos + 1] == "]":
            self.pos += 1
            return out
        while True:
            out.append(self.value(in_flow=True))
            self._skip()
            if self.text[self.pos : self.pos + 1] == "]":
                self.pos += 1
                return out
            self._expect(",")

    def _map(self) -> dict:
        self._expect("{")
        out: dict = {}
        self._skip()
        if self.text[self.pos : self.pos + 1] == "}":
            self.pos += 1
            return out
        while True:
            self._skip()
            if self.text[self.pos : self.pos + 1] in ("'", '"'):
                key, self.pos = _quoted(self.text, self.pos)
            else:
                key = _plain_scalar(self._plain(in_flow=True, key=True))
            self._expect(":")
            out[key] = self.value(in_flow=True)
            self._skip()
            if self.text[self.pos : self.pos + 1] == "}":
                self.pos += 1
                return out
            self._expect(",")

    def done(self) -> bool:
        self._skip()
        return self.pos == len(self.text)


def _inline_value(text: str) -> Any:
    parser = _Flow(text)
    value = parser.value(in_flow=False)
    if not parser.done():
        raise ValueError(f"trailing text in YAML value {text!r}")
    return value


def _split_key(content: str):
    """``key: rest`` -> (key, rest), or None if the line is no mapping entry."""
    if content[:1] in ("'", '"'):
        key, end = _quoted(content, 0)
        rest = content[end:]
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:].strip()
    if content[:1] in ("[", "{"):
        return None
    m = re.search(r":(?: |$)", content)
    if m is None:
        return None
    return _plain_scalar(content[: m.start()].strip()), content[m.end() :].strip()


def _is_seq_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Block:
    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines
        self.i = 0

    def node(self, indent: int) -> Any:
        if _is_seq_item(self.lines[self.i][1]):
            return self._seq(indent)
        return self._map(indent)

    def _nested(self, indent: int, parent_is_map: bool) -> Any:
        """Value on the lines after ``key:`` or ``-``; None when there is none."""
        if self.i >= len(self.lines):
            return None
        ind, content = self.lines[self.i]
        if ind > indent or (parent_is_map and ind == indent and _is_seq_item(content)):
            return self.node(ind)
        return None

    def _map(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent or (ind == indent and _is_seq_item(content)):
                break
            if ind > indent:
                raise ValueError(f"bad indentation: {content!r}")
            kv = _split_key(content)
            if kv is None:
                raise ValueError(f"expected a mapping entry: {content!r}")
            key, rest = kv
            self.i += 1
            out[key] = (
                _inline_value(rest) if rest else self._nested(indent, parent_is_map=True)
            )
        return out

    def _seq(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind != indent or not _is_seq_item(content):
                if ind > indent:
                    raise ValueError(f"bad indentation: {content!r}")
                break
            rest = content[1:].lstrip()
            if not rest:
                self.i += 1
                out.append(self._nested(indent, parent_is_map=False))
            elif _is_seq_item(rest) or _split_key(rest) is not None:
                # "- key: value" opens a mapping whose keys align with `key`
                # ("- - x" a sequence aligned with the inner dash).
                self.lines[self.i] = (indent + len(content) - len(rest), rest)
                out.append(self.node(self.lines[self.i][0]))
            else:
                self.i += 1
                out.append(_inline_value(rest))
        return out


def load_yaml_str(text: str) -> Any:
    """Parse YAML text of the supported subset (see module docstring)."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        stripped = _strip_comment(raw)
        if not stripped.strip():
            continue
        if stripped.strip() in ("---", "..."):
            raise ValueError("YAML document markers are outside the supported subset")
        indent = len(stripped) - len(stripped.lstrip(" "))
        lines.append((indent, stripped.strip()))
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.i != len(lines):
        raise ValueError(f"unparsed YAML from line: {lines[block.i][1]!r}")
    return value


def load_yaml(path: str) -> Any:
    """Read a YAML file of the supported subset into dicts and lists."""
    with open(path, "r") as f:
        return load_yaml_str(f.read())


# --- writing -------------------------------------------------------------

# A plain string may not start like a number (PyYAML also reads 0x10, 0o7,
# 1:20 and dates as numbers or timestamps), an indicator, a merge or value key.
_PLAIN_UNSAFE_START = tuple("-?:,[]{}#&*!|>'\"%@`+.<=0123456789 ")


def _scalar_text(value: Any) -> str:
    """One scalar as YAML text that both this reader and PyYAML read back
    as the same value."""
    if hasattr(value, "item") and not isinstance(value, (str, bytes)):
        value = value.item()  # numpy or torch scalar
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "." not in text:  # 1e-05 is a string to YAML 1.1; 1.0e-05 a float
            mantissa, _, exponent = text.partition("e")
            text = f"{mantissa}.0e{exponent}" if exponent else f"{mantissa}.0"
        return text
    if not isinstance(value, str):
        raise ValueError(f"cannot write {type(value).__name__} to YAML")
    if any(c in value for c in "\n\r\t\0\\") or not value.isprintable():
        escaped = (value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
                   .replace("\r", "\\r").replace("\t", "\\t").replace("\0", "\\0"))
        if not escaped.isprintable():
            raise ValueError(f"cannot write {value!r} to YAML")
        return f'"{escaped}"'
    try:
        plain = _plain_scalar(value) == value and isinstance(_plain_scalar(value), str)
    except ValueError:
        plain = False
    if (plain and value and not value.startswith(_PLAIN_UNSAFE_START)
            and value == value.strip() and ": " not in value and " #" not in value
            and not value.endswith(":")):
        return value
    return "'" + value.replace("'", "''") + "'"


def _emit(node: Any, indent: int, lines: List[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for key, value in node.items():
            key_text = _scalar_text(key)
            if isinstance(value, dict) and value:
                lines.append(f"{pad}{key_text}:")
                _emit(value, indent + 2, lines)
            elif isinstance(value, (list, tuple)) and len(value):
                lines.append(f"{pad}{key_text}:")
                _emit(value, indent, lines)  # PyYAML's style: "- " under the key
            else:
                lines.append(f"{pad}{key_text}: {_inline_text(value)}")
        return
    for item in node:
        if isinstance(item, (dict, list, tuple)) and len(item):
            inner: List[str] = []
            _emit(item, indent + 2, inner)
            inner[0] = f"{pad}- " + inner[0][indent + 2 :]
            lines.extend(inner)
        else:
            lines.append(f"{pad}- {_inline_text(item)}")


def _inline_text(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar_text(value)


def dump_yaml_str(data: Any) -> str:
    """Block-style YAML of nested dicts, lists and scalars, in the subset
    :func:`load_yaml_str` reads (and as PyYAML's ``safe_dump`` lays it out)."""
    if isinstance(data, (dict, list, tuple)):
        if not len(data):
            return _inline_text(data) + "\n"
        lines: List[str] = []
        _emit(data, 0, lines)
        return "\n".join(lines) + "\n"
    return _scalar_text(data) + "\n"


def save_yaml(data: Any, path: str, overwrite: bool = False) -> None:
    """Write a YAML sidecar (port of ``dream_tpu/utils/config.py:44``);
    refuses to overwrite an existing file unless ``overwrite``."""
    if not overwrite and os.path.exists(path):
        raise FileExistsError(f'Output file already exists in "{path}".')
    with open(path, "w") as f:
        f.write(dump_yaml_str(data))


def makedirs(directory: str, exist_ok: bool = False) -> None:
    """Create ``directory``; an existing one raises ``FileExistsError``
    unless ``exist_ok`` (port of ``dream_tpu/utils/config.py:83``)."""
    if os.path.exists(directory):
        if not exist_ok:
            raise FileExistsError(f'Specified directory "{directory}" already exists.')
    else:
        os.makedirs(directory)
