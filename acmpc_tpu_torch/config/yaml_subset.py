"""A parser for the YAML subset the track configs use (``configs/*.yaml``).

PyYAML is not a dependency of the port, so this reads what those files
hold and refuses the rest: block mappings, block sequences of scalars
(``- item``, indented or at the key's own indent), plain scalars and
``#`` comments. Scalars resolve as YAML 1.1 (PyYAML's ``safe_load``)
does: null, bool, decimal int, float, else string.
"""

from __future__ import annotations

import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
    r"|^\.[0-9_]+(?:[eE][-+][0-9]+)?$"
)
_INF = re.compile(r"^([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_UNSUPPORTED = tuple("[{&*!|>%@`'\"")


def _scalar(text: str):
    if text.startswith(_UNSUPPORTED):
        raise ValueError(f"unsupported YAML syntax: {text!r}")
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if re.match(r"^[-+]?0[0-9]", text) or text.startswith(("0x", "0b", "0o")):
        raise ValueError(f"unsupported number form: {text!r}")
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    inf = _INF.match(text)
    if inf:
        return float("-inf") if inf.group(1) == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at the line start or after a space)."""
    match = re.search(r"(^|\s)#", line)
    return line if match is None else line[: match.start()]


def _lines(text: str):
    out = []
    for number, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {number}: tab in indentation")
        line = _strip_comment(raw).rstrip()
        if line.strip() in ("", "---"):
            continue
        out.append((len(line) - len(line.lstrip(" ")), line.strip(), number))
    return out


def _split_key(content: str, number: int):
    match = re.match(r"^([^:]+?):(?:\s+(.*))?$", content)
    if match is None:
        raise ValueError(f"line {number}: expected 'key: value', got {content!r}")
    return match.group(1).strip(), (match.group(2) or "").strip()


def _block(lines, i: int, indent: int):
    """Parse the block starting at ``lines[i]`` (indent ``indent``);
    returns (value, index after the block)."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        return _sequence(lines, i, indent)
    return _mapping(lines, i, indent)


def _sequence(lines, i: int, indent: int):
    items = []
    while i < len(lines) and lines[i][0] == indent:
        _, content, number = lines[i]
        if not (content == "-" or content.startswith("- ")):
            break
        rest = content[1:].strip()
        if not rest or re.match(r"^[^:]*:(\s|$)", rest):
            raise ValueError(f"line {number}: only scalar list items are supported")
        items.append(_scalar(rest))
        i += 1
    return items, i


def _mapping(lines, i: int, indent: int):
    result = {}
    while i < len(lines):
        col, content, number = lines[i]
        if col < indent:
            break
        if col > indent:
            raise ValueError(f"line {number}: unexpected indentation")
        if content == "-" or content.startswith("- "):
            break
        key, rest = _split_key(content, number)
        if key in result:
            raise ValueError(f"line {number}: duplicate key {key!r}")
        i += 1
        if rest:
            result[key] = _scalar(rest)
            continue
        nested = i < len(lines) and (
            lines[i][0] > indent
            or (lines[i][0] == indent and lines[i][1].startswith("- "))
        )
        if nested:
            result[key], i = _block(lines, i, lines[i][0])
        else:
            result[key] = None
    return result, i


def parse_yaml(text: str):
    """Parse ``text`` (the subset above) into dicts, lists and scalars."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"line {lines[i][2]}: unexpected content")
    return value
