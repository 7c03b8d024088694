"""A reader of the YAML subset the run configs use, so that the CLI needs no
YAML package.

The subset: block mappings and block sequences (also a sequence written at
its key's indentation, as YAML emitters write it), flow sequences and flow
mappings on one line (``[Cu]``, ``{path: traj.dump, every: 100}``), plain,
single- and double-quoted scalars, and ``#`` comments.  Plain scalars
resolve as YAML 1.1's core types do in ``yaml.safe_load``: null, bool,
int (decimal, octal, hex, binary, sexagesimal), float (a dot is required;
``.inf``, ``.nan``), else str.  Anchors, aliases, tags, block scalars,
merge keys, timestamps, multi-line scalars and a second document raise
``ValueError`` naming the line.
"""

from __future__ import annotations

import re
from typing import NamedTuple

_NULL = ("~", "null", "Null", "NULL", "")
_TRUE = ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")
_FALSE = ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_OUTSIDE = "anchors, aliases, tags, block scalars and directives are outside the supported subset"


class _Line(NamedTuple):
    no: int  # 1-based line number in the file
    indent: int
    text: str  # stripped of indentation, comment and trailing blanks


def _error(no: int, what: str) -> ValueError:
    return ValueError(f"config line {no}: {what}")


def _strip_comment(s: str) -> str:
    """``s`` without a ``#`` comment (one that starts the line or follows a
    blank, outside quotes)."""
    quote = None
    k = 0
    while k < len(s):
        ch = s[k]
        if quote == '"' and ch == "\\":
            k += 2
            continue
        if quote == "'" and s[k:k + 2] == "''":
            k += 2  # an escaped quote
            continue
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (k == 0 or s[k - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (k == 0 or s[k - 1] in " \t"):
            return s[:k].rstrip()
        k += 1
    return s.rstrip()


def _resolve_plain(s: str, no: int):
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if s[0] in "&*!|>%@`":
        raise _error(no, f"{s!r}: {_OUTSIDE}")
    if s == "=" or (s[0] in "-?:" and (len(s) == 1 or s[1] in " \t")):
        # a block indicator where a value stands (PyYAML's scanner and
        # parser refuse these), or '=' (its constructor refuses the value tag)
        raise _error(no, f"{s!r}: an indicator ('-', '?' or ':' alone or before a blank, or '=') "
                         "is not a plain scalar")
    if s == "<<":
        raise _error(no, "merge keys are outside the supported subset")
    if ": " in s or s.endswith(":"):
        raise _error(no, f"{s!r}: a mapping value is not allowed here")
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0"):
            return sign * int(v, 8)
        if ":" in v:
            out = 0
            for part in v.split(":"):
                out = out * 60 + int(part)
            return sign * out
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            out = 0.0
            for part in v.split(":"):
                out = out * 60 + float(part)
            return sign * out
        return sign * float(v)
    if _TIMESTAMP.match(s):
        raise _error(no, f"{s!r}: timestamps are outside the supported subset")
    return s


def _quoted(s: str, k: int, no: int) -> tuple[str, int]:
    """The quoted scalar starting at s[k]; returns (value, index after it)."""
    q = s[k]
    out = []
    k += 1
    while k < len(s):
        ch = s[k]
        if q == "'" and ch == "'":
            if s[k + 1:k + 2] == "'":
                out.append("'")
                k += 2
                continue
            return "".join(out), k + 1
        if q == '"' and ch == '"':
            return "".join(out), k + 1
        if q == '"' and ch == "\\":
            e = s[k + 1:k + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                k += 2
            elif e in _HEX_ESCAPES:
                width = _HEX_ESCAPES[e]
                code = s[k + 2:k + 2 + width]
                if len(code) != width or not all(c in "0123456789abcdefABCDEF" for c in code):
                    raise _error(no, f"bad escape \\{e}{code}")
                out.append(chr(int(code, 16)))
                k += 2 + width
            else:
                raise _error(no, f"unknown escape \\{e}")
            continue
        out.append(ch)
        k += 1
    raise _error(no, "unterminated quoted scalar (multi-line scalars are outside the subset)")


class _Flow:
    """One line's flow node: ``[a, b]``, ``{k: v}``, nested."""

    def __init__(self, s: str, no: int):
        self.s, self.no, self.k = s, no, 0

    def _skip(self):
        while self.k < len(self.s) and self.s[self.k] == " ":
            self.k += 1

    def _peek(self) -> str:
        self._skip()
        if self.k >= len(self.s):
            raise _error(self.no, "unterminated flow collection (it must end on its line)")
        return self.s[self.k]

    def node(self, in_map_key: bool = False):
        ch = self._peek()
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in "\"'":
            v, self.k = _quoted(self.s, self.k, self.no)
            return v
        start = self.k
        while self.k < len(self.s):
            c = self.s[self.k]
            if c in ",[]{}":
                break
            if c == ":" and (self.k + 1 == len(self.s) or self.s[self.k + 1] in " ,[]{}"):
                if not in_map_key:
                    raise _error(self.no, "a mapping inside a flow sequence is outside the subset")
                break
            self.k += 1
        return _resolve_plain(self.s[start:self.k].strip(), self.no)

    def _seq(self) -> list:
        self.k += 1
        out = []
        while self._peek() != "]":
            out.append(self.node())
            if self._peek() == ",":
                self.k += 1
            elif self._peek() != "]":
                raise _error(self.no, f"expected ',' or ']' at column {self.k + 1}")
        self.k += 1
        return out

    def _map(self) -> dict:
        self.k += 1
        out = {}
        while self._peek() != "}":
            key = self.node(in_map_key=True)
            value = None
            if self._peek() == ":":
                self.k += 1
                value = None if self._peek() in ",}" else self.node()
            out[key] = value
            if self._peek() == ",":
                self.k += 1
            elif self._peek() != "}":
                raise _error(self.no, f"expected ',' or '}}' at column {self.k + 1}")
        self.k += 1
        return out


def _scalar_or_flow(text: str, no: int):
    """A value written on one line: a flow node, a quoted or a plain scalar."""
    if text[0] in "[{":
        f = _Flow(text, no)
        v = f.node()
        f._skip()
        if f.k != len(text):
            raise _error(no, f"unexpected text after the flow collection: {text[f.k:]!r}")
        return v
    if text[0] in "\"'":
        v, k = _quoted(text, 0, no)
        if text[k:].strip():
            raise _error(no, f"unexpected text after the quoted scalar: {text[k:]!r}")
        return v
    return _resolve_plain(text, no)


def _split_key(text: str, no: int):
    """(key, rest) of a ``key: value`` line, or None if it is no mapping
    entry."""
    if text[0] in "[{":
        return None
    k = 0
    if text[0] in "\"'":
        key, k = _quoted(text, 0, no)
        rest = text[k:].lstrip()
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    while k < len(text):
        if text[k] == ":" and (k + 1 == len(text) or text[k + 1] == " "):
            return _resolve_plain(text[:k].strip(), no), text[k + 1:].strip()
        k += 1
    return None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    def __init__(self, lines: list[_Line]):
        self.lines = lines
        self.i = 0

    def _deeper(self, indent: int) -> bool:
        return self.i < len(self.lines) and self.lines[self.i].indent > indent

    def node(self, indent: int):
        line = self.lines[self.i]
        if _is_item(line.text):
            return self._seq(indent)
        if _split_key(line.text, line.no) is not None:
            return self._map(indent)
        self.i += 1
        if self._deeper(indent):
            raise _error(self.lines[self.i].no, "a node that goes on past its line (multi-line "
                         "scalars and flow collections are outside the subset)")
        return _scalar_or_flow(line.text, line.no)

    def _value_after(self, indent: int, rest: str, no: int, indentless_ok: bool):
        """The value of an entry whose line ends with ``rest``."""
        if rest:
            v = _scalar_or_flow(rest, no)
            if self._deeper(indent):
                raise _error(self.lines[self.i].no,
                             "unexpected indentation (multi-line scalars are outside the subset)")
            return v
        if self._deeper(indent):
            return self.node(self.lines[self.i].indent)
        if (indentless_ok and self.i < len(self.lines) and self.lines[self.i].indent == indent
                and _is_item(self.lines[self.i].text)):
            return self._seq(indent)
        return None

    def _map(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise _error(line.no, "unexpected indentation")
            if _is_item(line.text):
                if out:
                    break  # an indentless sequence ends the mapping above it
                raise _error(line.no, "a sequence item where a mapping entry was expected")
            kv = _split_key(line.text, line.no)
            if kv is None:
                raise _error(line.no, f"expected 'key: value', got {line.text!r}")
            self.i += 1
            out[kv[0]] = self._value_after(indent, kv[1], line.no, indentless_ok=True)
        return out

    def _seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if line.indent < indent or (line.indent == indent and not _is_item(line.text)):
                break
            if line.indent > indent:
                raise _error(line.no, "unexpected indentation")
            rest = line.text[1:]
            body = rest.lstrip(" ")
            if not body:
                self.i += 1
                out.append(self._value_after(indent, "", line.no, indentless_ok=False))
                continue
            # the item's node starts on this line, at the column of its text
            col = indent + 1 + len(rest) - len(body)
            self.lines[self.i] = _Line(line.no, col, body)
            out.append(self.node(col))
        return out


def parse_config(text: str):
    """Parse one YAML document of the supported subset (see the module
    docstring); an empty document gives None."""
    lines = []
    for no, raw in enumerate(text.splitlines(), start=1):
        body = raw.lstrip(" ")
        if body.startswith("\t"):
            raise _error(no, "tabs may not indent")
        body = _strip_comment(body)
        if not body:
            continue
        if body == "---" or body.startswith("--- ") or body == "...":
            if body == "---" and not lines:
                continue  # the first document's own start marker
            raise _error(no, "more than one document is outside the supported subset")
        if body[0] in "&*!|>%@`":
            raise _error(no, _OUTSIDE)
        lines.append(_Line(no, len(raw) - len(raw.lstrip(" ")), body))
    if not lines:
        return None
    block = _Block(lines)
    out = block.node(lines[0].indent)
    if block.i < len(lines):
        raise _error(lines[block.i].no, "unexpected text after the document's top-level node")
    return out


def load_config(path: str):
    """Read and parse a config file (see :func:`parse_config`)."""
    with open(path) as f:
        return parse_config(f.read())
