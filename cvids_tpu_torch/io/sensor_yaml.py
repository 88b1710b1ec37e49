"""A reader for the YAML subset of EuRoC's `sensor.yaml` files (port-only).

The JAX package reads them with PyYAML (`cvids_tpu/io/euroc.py:67`); the
port carries this reader so that it needs no YAML library. It takes:

- the `%YAML:1.0` directive and OpenCV's `!!opencv-matrix` tag (both
  dropped, as `euroc.py:75,110` drop them before `yaml.safe_load`);
- `key: value` pairs, and maps nested by indentation (`key:` alone on its
  line, its entries indented below);
- flow lists `[a, b, ...]`, also across lines (EuRoC's own `T_BS: data:`);
- `#` comments, on their own line or after a value;
- scalars resolved as PyYAML's `safe_load` resolves them (YAML 1.1): ints,
  floats (which need a dot: `5e-05` stays a string, as in PyYAML), `.inf`,
  `.nan`, booleans, null, and strings, quoted or plain.

`loads` returns what `yaml.safe_load` returns on such a text; anything
outside the subset (block sequences, anchors, other tags, multi-line
strings) raises ValueError.
"""

from __future__ import annotations

import re

__all__ = ["loads", "load"]

# PyYAML's implicit resolvers (yaml/resolver.py), without the sexagesimal forms
_INT = re.compile(r"^[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")


def _scalar(text: str):
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        body = s.replace("_", "")
        sign, digits = (-1, body[1:]) if body[0] == "-" else (1, body.lstrip("+"))
        if digits.startswith(("0b", "0x")):
            return sign * int(digits, 0)
        if len(digits) > 1 and digits[0] == "0":
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(s):
        body = s.replace("_", "").lower()
        if body.endswith(".inf"):
            return float("-inf") if body[0] == "-" else float("inf")
        if body.endswith(".nan"):
            return float("nan")
        return float(body)
    if s.startswith(("&", "*", "!", "|", ">", "[", "]", "{", "}", "- ", "? ", "@", "`")) or ": " in s:
        raise ValueError(f"sensor.yaml: unsupported value {s!r}")
    return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _flow_list(text: str) -> list:
    inner = text.strip()
    if not (inner.startswith("[") and inner.endswith("]")) or "[" in inner[1:-1]:
        raise ValueError(f"sensor.yaml: unsupported flow value {text!r}")
    body = inner[1:-1].strip()
    return [_scalar(v) for v in body.split(",")] if body else []


def _logical_lines(text: str) -> list[tuple[int, str]]:
    """(indent, content) per logical line: comments, directives, document
    markers and blank lines dropped, flow lists joined across lines."""
    out, pending = [], None
    for raw in text.replace("\t", "    ").splitlines():
        if raw.startswith("%") or raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw.replace("!!opencv-matrix", ""))
        if pending is not None:
            pending[1] += " " + line.strip()
            if pending[1].count("[") <= pending[1].count("]"):
                out.append(tuple(pending))
                pending = None
            continue
        if not line.strip():
            continue
        item = [len(line) - len(line.lstrip(" ")), line.strip()]
        if item[1].count("[") > item[1].count("]"):
            pending = item
        else:
            out.append(tuple(item))
    if pending is not None:
        raise ValueError("sensor.yaml: unterminated flow list")
    return out


def _block(lines, pos: int, indent: int) -> tuple[dict, int]:
    out = {}
    while pos < len(lines):
        ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"sensor.yaml: unexpected indentation at {content!r}")
        key, sep, value = content.partition(":")
        if not sep or (value and value[0] not in " ") or content.startswith("- "):
            raise ValueError(f"sensor.yaml: unsupported line {content!r}")
        key, value = _scalar(key), value.strip()
        pos += 1
        if value:
            out[key] = _flow_list(value) if value.startswith("[") else _scalar(value)
        elif pos < len(lines) and lines[pos][0] > indent:
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def loads(text: str) -> dict | None:
    """The mapping a `sensor.yaml` text holds (None for an empty text)."""
    lines = _logical_lines(text)
    if not lines:
        return None
    out, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"sensor.yaml: unexpected indentation at {lines[pos][1]!r}")
    return out


def load(path: str) -> dict | None:
    with open(path) as f:
        return loads(f.read())
