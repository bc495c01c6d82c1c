"""A reader for the YAML subset of the repository's experiment files.

The JAX package reads its presets and command-line override values with
PyYAML's `safe_load`; the port reads them with this module and gives the
same Python objects for what those files and values use:
  * block mappings and block sequences (a sequence item may open a
    mapping: `- name: re10k`), nested by indentation;
  * flow sequences of scalars (`[32,32]`, `['/data/x']`, `[]`);
  * comments (`# ...` at the start of a line or after whitespace);
  * scalars resolved as YAML 1.1 resolves them: null (`null`, `~`,
    nothing), booleans (`true`/`false`, `yes`/`no`, `on`/`off` in their
    three spellings), decimal integers, floats (`0.0005`, `1.0e-05`,
    `.inf`; `1.0e10` has an unsigned exponent and stays a string, as in
    PyYAML), and plain, single- and double-quoted strings.
Anything else (anchors, tags, block scalars, flow mappings, multiple
documents, binary/octal/hex/sexagesimal numbers, timestamps, tabs)
raises `YAMLError`.
"""

from __future__ import annotations

import re
from typing import Any


class YAMLError(ValueError):
    pass


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)\Z")
_FLOAT = re.compile(
    r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))\Z"
)
# Implicit forms PyYAML resolves that this reader does not: binary,
# octal, hexadecimal and sexagesimal numbers, timestamps, merge and value
# keys.
_UNSUPPORTED = re.compile(
    r"(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)\Z"
)
_INDICATORS = set("&*!|>%@`{")


def _plain(text: str) -> Any:
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    if _UNSUPPORTED.match(text) or text[0] in _INDICATORS:
        raise YAMLError(f"unsupported YAML scalar {text!r}")
    if text.startswith(("- ", "? ", ": ")) or text in ("-", "?"):
        raise YAMLError(f"unsupported YAML scalar {text!r}")
    return text


def _quoted(text: str) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise YAMLError(f"unterminated string {text!r}")
    body = text[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise YAMLError(f"bad single-quoted string {text!r}")
        return body.replace("''", "'")
    if "\\" in body or '"' in body:
        raise YAMLError(f"escapes in double-quoted strings are unsupported: {text!r}")
    return body


def _strip_comment(line: str) -> str:
    """Drop a comment that starts outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_flow(body: str) -> list[str]:
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur.strip())
            cur = ""
        elif ch in "[]{}":
            raise YAMLError(f"nested flow collections are unsupported: [{body}]")
        else:
            cur += ch
    if quote:
        raise YAMLError(f"unterminated string in [{body}]")
    items.append(cur.strip())
    if items == [""]:
        return []
    if items[-1] == "":          # a trailing comma, as in [1, 2,]
        items.pop()
    if any(i == "" for i in items):
        raise YAMLError(f"empty flow sequence item in [{body}]")
    return items


def scalar(text: str) -> Any:
    """One inline value: a flow sequence, a quoted or a plain scalar."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise YAMLError(f"unterminated flow sequence {text!r}")
        return [scalar(item) for item in _split_flow(text[1:-1])]
    if text[:1] in ("'", '"'):
        return _quoted(text)
    return _plain(text)


def _key(text: str) -> str:
    text = text.strip()
    if text[:1] in ("'", '"'):
        return _quoted(text)
    value = _plain(text)
    if not isinstance(value, str):
        raise YAMLError(f"non-string mapping key {text!r}")
    return value


def _split_key(text: str):
    """'key: value' -> (key, value text) or None if `text` is no entry."""
    m = re.match(r"""((?:'[^']*'|"[^"]*"|[^'"#:\s][^:#]*?))\s*:(?:\s+(.*)|)\Z""",
                 text)
    if m is None:
        return None
    return _key(m.group(1)), (m.group(2) or "")


class _Parser:
    def __init__(self, text: str):
        self.lines = []
        for n, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise YAMLError(f"line {n}: tab indentation")
            stripped = _strip_comment(raw)
            if not stripped.strip():
                continue
            body = stripped.strip()
            if body in ("---", "...") or body.startswith("%"):
                raise YAMLError(f"line {n}: document markers are unsupported")
            self.lines.append((len(stripped) - len(stripped.lstrip()), body, n))
        self.i = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        value = self.block(self.lines[0][0])
        if self.i != len(self.lines):
            _, body, n = self.lines[self.i]
            raise YAMLError(f"line {n}: unexpected {body!r}")
        return value

    def block(self, indent: int) -> Any:
        body = self.lines[self.i][1]
        if body == "-" or body.startswith("- "):
            return self.sequence(indent)
        if _split_key(body) is not None:
            return self.mapping(indent)
        self.i += 1
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise YAMLError(f"line {self.lines[self.i][2]}: multi-line scalars "
                            "are unsupported")
        return scalar(body)

    def value_after(self, rest: str, indent: int, n: int) -> Any:
        """The value of an entry whose inline text is `rest`."""
        if rest:
            return scalar(rest)
        if self.i < len(self.lines):
            nxt_indent, nxt, _ = self.lines[self.i]
            # A block sequence may sit at its key's indentation.
            if nxt_indent > indent or (
                    nxt_indent == indent and (nxt == "-" or nxt.startswith("- "))):
                return self.block(nxt_indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            ind, body, n = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLError(f"line {n}: bad indentation")
            entry = _split_key(body)
            if entry is None:
                raise YAMLError(f"line {n}: expected 'key: value', got {body!r}")
            key, rest = entry
            if key in out:
                raise YAMLError(f"line {n}: duplicate key {key!r}")
            self.i += 1
            out[key] = self.value_after(rest, indent, n)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, body, n = self.lines[self.i]
            if ind < indent or not (body == "-" or body.startswith("- ")):
                if ind > indent:
                    raise YAMLError(f"line {n}: bad indentation")
                break
            if ind > indent:
                raise YAMLError(f"line {n}: bad indentation")
            rest = body[1:].lstrip()
            if not rest:
                self.i += 1
                out.append(self.value_after("", indent, n))
                continue
            # The item's content starts at its own column: rewrite this
            # line as that content and parse a block there.
            col = ind + (len(body) - len(rest))
            self.lines[self.i] = (col, rest, n)
            out.append(self.block(col))
        return out


def safe_load(text: str) -> Any:
    """Parse `text` (a whole document or one override value)."""
    return _Parser(text).parse()
