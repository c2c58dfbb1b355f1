"""A small YAML reader and writer for the repo's config files.

The config machinery of the JAX package reads YAML with PyYAML
(`cips3d_tpu/config/config.py`).  The port reads the subset its
`configs/*.yaml` use, with the Python standard library only:

  * block mappings and block sequences (``- item``), nested by indentation;
  * anchors (``&name``) and aliases (``*name``) on block nodes and scalars;
  * flow collections on one line (``[a, b]``, ``{k: v}``), plain and quoted
    scalars (single quotes double ``''``; double quotes take the common
    backslash escapes);
  * comments, blank lines and a leading ``---``.

Plain scalars resolve as PyYAML's safe loader resolves them (YAML 1.1):
``null``/``~``/empty, the YAML 1.1 booleans (``yes``/``no``/``on``/``off``
as well as ``true``/``false``), decimal/octal/hex/binary integers with
``_`` separators, and floats only with a dot (``1e-5`` stays a string, as
there).  Multi-line scalars, tags, merge keys and documents after the first
are refused with an error.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


class YAMLError(ValueError):
    pass


def resolve_scalar(text: str) -> Any:
    """A plain scalar's value, as PyYAML's safe loader resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return -math.inf if t[0] == "-" else math.inf
        if t.endswith("nan"):
            return math.nan
        return float(t)
    return text


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:-[{,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _quoted(text: str) -> Tuple[str, str]:
    """A quoted scalar at the start of ``text``: (value, rest)."""
    q = text[0]
    out, i = [], 1
    esc = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0", "r": "\r"}
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            nxt = text[i + 1:i + 2]
            if nxt not in esc:
                raise YAMLError(f"unsupported escape \\{nxt} in {text!r}")
            out.append(esc[nxt])
            i += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        out.append(ch)
        i += 1
    raise YAMLError(f"unterminated quoted scalar {text!r}")


class _Reader:
    def __init__(self, text: str):
        self.anchors: Dict[str, Any] = {}
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YAMLError("tabs in indentation")
            line = _strip_comment(raw)
            if not line.strip():
                continue
            if line.strip() == "---" and not self.lines:
                continue
            if line.startswith(("---", "...")) or line.lstrip().startswith(("%", "!")):
                raise YAMLError(f"unsupported line {raw!r}")
            self.lines.append((len(line) - len(line.lstrip()), line.strip()))
        self.pos = 0

    # ---- scalars and flow collections ----

    def value(self, text: str) -> Any:
        """The value of inline ``text`` (after a key or a dash)."""
        anchor = None
        if text.startswith("&"):
            anchor, _, text = text[1:].partition(" ")
            text = text.strip()
        if text.startswith("*"):
            if anchor:
                raise YAMLError("an alias cannot carry an anchor")
            name = text[1:]
            if name not in self.anchors:
                raise YAMLError(f"unknown alias *{name}")
            return self.anchors[name]
        if text.startswith(("|", ">", "!", "<<")):
            raise YAMLError(f"unsupported scalar {text!r}")
        if text.startswith(("[", "{")):
            out, rest = self.flow(text)
            if rest.strip():
                raise YAMLError(f"trailing text after a flow collection: {rest!r}")
        elif text[:1] in "'\"":
            out, rest = _quoted(text)
            if rest.strip():
                raise YAMLError(f"trailing text after a quoted scalar: {rest!r}")
        else:
            out = resolve_scalar(text)
        if anchor:
            self.anchors[anchor] = out
        return out

    def flow(self, text: str) -> Tuple[Any, str]:
        """A flow sequence or mapping at the start of ``text``: (value, rest)."""
        close = "]" if text[0] == "[" else "}"
        items, pairs = [], {}
        rest = text[1:].lstrip()
        while True:
            if rest.startswith(close):
                return (items if close == "]" else pairs), rest[1:]
            if rest[:1] in "[{":
                item, rest = self.flow(rest)
            elif rest[:1] in "'\"":
                item, rest = _quoted(rest)
            else:
                m = re.match(r"[^,\]\}]*" if close == "]" else r"[^,\}:]*(?::(?!\s)[^,\}:]*)*",
                             rest)
                item, rest = resolve_scalar(m.group(0).strip()), rest[m.end():]
            rest = rest.lstrip()
            if close == "}":
                if not rest.startswith(":"):
                    raise YAMLError(f"flow mapping entry without a value: {text!r}")
                rest = rest[1:].lstrip()
                if rest[:1] in "[{":
                    val, rest = self.flow(rest)
                elif rest[:1] in "'\"":
                    val, rest = _quoted(rest)
                else:
                    m = re.match(r"[^,\}]*", rest)
                    val, rest = resolve_scalar(m.group(0).strip()), rest[m.end():]
                pairs[item] = val
                rest = rest.lstrip()
            else:
                items.append(item)
            if rest.startswith(","):
                rest = rest[1:].lstrip()
            elif not rest.startswith(close):
                raise YAMLError(f"bad flow collection {text!r}")

    # ---- block nodes ----

    def key_value(self, text: str) -> Tuple[Any, Optional[str]]:
        """Split ``key: rest`` (rest None when the line ends after the colon)."""
        if text[:1] in "'\"":
            key, rest = _quoted(text)
            rest = rest.lstrip()
            if not rest.startswith(":"):
                raise YAMLError(f"expected ':' after {text!r}")
            rest = rest[1:]
        else:
            m = re.match(r"(.*?):(?:\s|$)", text)
            if not m:
                raise YAMLError(f"expected 'key: value', got {text!r}")
            key, rest = resolve_scalar(m.group(1).strip()), text[m.end():]
        rest = rest.strip()
        return key, (rest or None)

    def nested(self, indent: int, text: Optional[str]) -> Any:
        """The value of a key or dash whose inline text is ``text``: inline,
        or the block below it, deeper than ``indent`` (a sequence may sit at
        the same indent as its mapping key)."""
        anchor = None
        if text is not None and text.startswith("&") and " " not in text:
            anchor, text = text[1:], None
        if text is not None:
            return self.value(text)
        out = None
        if self.pos < len(self.lines):
            ind, line = self.lines[self.pos]
            if ind > indent or (ind == indent and (line == "-" or line.startswith("- "))):
                out = self.block(ind)
        if anchor:
            self.anchors[anchor] = out
        return out

    def block(self, indent: int) -> Any:
        ind, line = self.lines[self.pos]
        if line == "-" or line.startswith("- "):
            return self.sequence(indent)
        return self.mapping(indent)

    def sequence(self, indent: int) -> list:
        out = []
        while self.pos < len(self.lines):
            ind, line = self.lines[self.pos]
            if ind != indent or not (line == "-" or line.startswith("- ")):
                if ind > indent:
                    raise YAMLError(f"bad indentation at {line!r}")
                break
            self.pos += 1
            rest = line[1:].strip()
            if rest == "-" or rest.startswith("- ") or (
                    rest and not rest.startswith(("[", "{", "'", '"', "*", "&"))
                    and re.match(r"(.*?):(\s|$)", rest)):
                # "- key: value" or "- - x" opens a block at the dash's content column
                col = indent + (len(line) - len(rest))
                self.lines.insert(self.pos, (col, rest))
                out.append(self.block(col))
            else:
                out.append(self.nested(indent, rest or None))
        return out

    def mapping(self, indent: int) -> dict:
        out: Dict[Any, Any] = {}
        while self.pos < len(self.lines):
            ind, line = self.lines[self.pos]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLError(f"bad indentation at {line!r}")
            if line == "-" or line.startswith("- "):
                break
            self.pos += 1
            key, rest = self.key_value(line)
            if key == "<<":
                raise YAMLError("merge keys are not supported")
            if key in out:
                raise YAMLError(f"duplicate key {key!r}")
            out[key] = self.nested(indent, rest)
        return out


def safe_load(text: str) -> Any:
    """Parse YAML ``text`` (the subset above) into dicts, lists and scalars."""
    r = _Reader(text)
    if not r.lines:
        return None
    ind, line = r.lines[0]
    if line == "-" or line.startswith("- ") or (
            not line.startswith(("[", "{", "'", '"', "*")) and re.match(r"(.*?):(\s|$)", line)):
        out = r.block(ind)
    else:
        out = r.value(line)
        r.pos = 1
    if r.pos != len(r.lines):
        raise YAMLError(f"unparsed content at {r.lines[r.pos][1]!r}")
    return out


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        return r if "." in r or "e" not in r else r.replace("e", ".0e", 1)
    s = str(v)
    special = re.search(r"[:#\[\]{},&*!|>'\"%@`]", s)
    if resolve_scalar(s) != s or not s or s != s.strip() or special or s.startswith("-"):
        return "'" + s.replace("'", "''") + "'"
    return s


def safe_dump(obj: Any, indent: int = 0) -> str:
    """Block-style YAML of dicts, lists and scalars that `safe_load` reads
    back to the same value; keys keep their order."""
    pad = " " * indent
    if isinstance(obj, dict):
        if not obj:
            return pad + "{}\n"
        out = []
        for k, v in obj.items():
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}{_scalar_text(k)}:\n{safe_dump(v, indent + 2)}")
            else:
                out.append(f"{pad}{_scalar_text(k)}: {safe_dump(v).strip()}\n")
        return "".join(out)
    if isinstance(obj, list):
        if not obj:
            return pad + "[]\n"
        out = []
        for v in obj:
            if isinstance(v, (dict, list)) and v:
                out.append(f"{pad}-\n{safe_dump(v, indent + 2)}")
            else:
                out.append(f"{pad}- {safe_dump(v).strip()}\n")
        return "".join(out)
    return pad + _scalar_text(obj) + "\n"
