"""The port's own YAML subset: the configs of packed model directories and
recipes, read and written without the ``yaml`` package.

``load(text)`` reads block mappings and sequences (indentless sequences
included), flow mappings and sequences (nested, over several lines),
plain, single- and double-quoted scalars (over several lines too) and
comments.  Plain scalars resolve as PyYAML's YAML 1.1 resolver
(``yaml.safe_load``) resolves them: ``yes``/``no``/``on``/``off`` are
bools, ``1e-5`` is a string but ``1.0e-05`` a float, ``012`` is octal,
``1:30`` sexagesimal, ``~`` and the empty value null.  Anchors, aliases,
tags, block scalars, complex keys, directives, merge keys and timestamps
raise ``YAMLError`` with the line number.

``dump(obj)`` writes what ``yaml.safe_dump(obj, sort_keys=False)`` writes
for dicts, lists, tuples, str, int, float, bool and None: block style,
indentless sequences, the same scalar forms and the same quoting, so that
PyYAML reads it back as the same value.  Two things differ in text only:
a string holding a line break is written double-quoted with ``\\n``
(PyYAML writes it single-quoted over several lines), and long strings are
not folded at 80 columns.
"""

from __future__ import annotations

import math
import re
from typing import Any, List


class YAMLError(ValueError):
    """Input outside the subset, or malformed."""


# PyYAML's implicit resolvers (yaml/resolver.py), in its order of trial
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False
                    |FALSE|on|On|ON|off|Off|OFF)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_RESOLVERS = (  # (tag, pattern, first characters it is tried on)
    ("bool", _BOOL, "yYnNtTfFoO"),
    ("float", _FLOAT, "-+0123456789."),
    ("int", _INT, "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", _NULL, "~nN"),
    ("timestamp", _TIMESTAMP, "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
)


def _implicit_tag(s: str) -> str:
    """The tag PyYAML's resolver gives the plain scalar ``s``."""
    if s == "":
        return "null"
    for tag, pattern, first in _RESOLVERS:
        if s[0] in first and pattern.match(s):
            return tag
    return "str"


def _sexagesimal(value: str) -> float:
    out = 0
    for part in value.split(":"):
        out = out * 60 + float(part)
    return out


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * int(_sexagesimal(value))
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value)
    return sign * float(value)


# ------------------------------------------------------------------ reader
_WS = " \t"
_FLOW_IND = ",[]{}"
_DQ_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
               "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
               " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
               "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}


class _Reader:
    """Recursive descent over the text; ``i`` is the read position."""

    def __init__(self, text: str):
        self.s = text.replace("\r\n", "\n").replace("\r", "\n")
        if self.s.startswith("\ufeff"):
            self.s = self.s[1:]
        self.i = 0

    # ---------------------------------------------------------- position
    def error(self, msg: str, at: int | None = None):
        at = self.i if at is None else at
        line = self.s.count("\n", 0, at) + 1
        raise YAMLError(f"line {line}: {msg}")

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def col(self, at: int | None = None) -> int:
        at = self.i if at is None else at
        return at - (self.s.rfind("\n", 0, at) + 1)

    def eof(self) -> bool:
        return self.i >= len(self.s)

    def space_after(self, k: int) -> bool:
        """Whether the character k ahead is a blank, a break or the end."""
        c = self.peek(k)
        return c == "" or c in _WS or c == "\n"

    def skip_inline_space(self):
        while self.peek() in (" ", "\t"):
            self.i += 1

    def skip_to_content(self):
        """Past blanks, comments and line breaks, to the next token (or the
        end).  Tabs may not indent."""
        while not self.eof():
            c = self.peek()
            if c == " ":
                self.i += 1
            elif c == "\t":
                if self.s[self.s.rfind("\n", 0, self.i) + 1:self.i].strip(_WS):
                    self.i += 1
                else:
                    self.error("a tab character cannot indent")
            elif c == "\n":
                self.i += 1
            elif c == "#":
                self.skip_comment()
            else:
                return

    def skip_comment(self):
        j = self.s.find("\n", self.i)
        self.i = len(self.s) if j < 0 else j

    def at_line_end(self) -> bool:
        """Skip inline blanks and a comment; whether the line ends here."""
        self.skip_inline_space()
        if self.peek() == "#":
            self.skip_comment()
        return self.peek() in ("", "\n")

    # ---------------------------------------------------------- document
    def document(self) -> Any:
        self.skip_to_content()
        if self.peek() == "%":
            self.error("directives are not supported")
        if self.s.startswith("---", self.i) and self.space_after(3):
            self.i += 3
            if not self.at_line_end():
                return self.finish(self.block_node_inline(-1))
        return self.finish(self.block_node(-1))

    def finish(self, value):
        self.skip_to_content()
        if self.s.startswith("...", self.i) and self.space_after(3):
            self.i += 3
            self.skip_to_content()
        if not self.eof():
            if self.s.startswith("---", self.i):
                self.error("only one document is supported")
            self.error(f"unexpected {self.peek()!r}")
        return value

    def check_indicator(self):
        c = self.peek()
        what = {"&": "anchors", "*": "aliases", "!": "tags",
                "|": "block scalars", ">": "block scalars",
                "%": "directives", "@": "reserved indicators",
                "`": "reserved indicators"}.get(c)
        if what:
            self.error(f"{what} are not supported ({c!r})")
        if c == "?" and self.space_after(1):
            self.error("complex mapping keys are not supported")

    # ------------------------------------------------------------ blocks
    def block_node(self, parent: int) -> Any:
        """The node after a line break: more indented than ``parent``, or
        null when the next token is not."""
        self.skip_to_content()
        if self.eof() or self.col() <= parent:
            return None
        if self.s.startswith(("---", "..."), self.i) and self.col() == 0 \
                and self.space_after(3):
            return None
        return self.block_node_inline(parent)

    def block_node_inline(self, parent: int) -> Any:
        """A node starting at the read position; its indentation is its
        column (a compact mapping or sequence inside a ``- `` item)."""
        self.check_indicator()
        indent = self.col()
        c = self.peek()
        if c == "-" and self.space_after(1):
            return self.block_sequence(indent)
        if c in "[{":
            start = self.i
            value = self.flow_node()
            if not self.at_line_end():
                self.error("text after a flow collection", start)
            return value
        key_start = self.i
        if self.is_mapping_key():
            self.i = key_start
            return self.block_mapping(indent)
        self.i = key_start
        return self.block_scalar_value(parent)

    def is_mapping_key(self) -> bool:
        """Read a would-be simple key; whether ``:`` and a blank follow."""
        c = self.peek()
        if c in "'\"":
            line = self.s.count("\n", 0, self.i)
            self.quoted()
            if self.s.count("\n", 0, self.i) != line:
                return False
        else:
            self.plain(block=True, parent=None)
        self.skip_inline_space()
        return self.peek() == ":" and self.space_after(1)

    def block_sequence(self, indent: int) -> list:
        out = []
        while True:
            # at "- " in column ``indent``
            self.i += 1
            if self.at_line_end():
                out.append(self.block_node(indent))
            else:
                out.append(self.block_node_inline(indent))
            self.skip_to_content()
            if self.eof() or self.col() < indent:
                return out
            if self.col() > indent:
                self.error("bad indentation of a sequence entry")
            if not (self.peek() == "-" and self.space_after(1)):
                return out  # an indentless sequence ends at its key's peer

    def block_mapping(self, indent: int) -> dict:
        out = {}
        while True:
            self.check_indicator()
            key = self.scalar_key()
            self.skip_inline_space()
            if not (self.peek() == ":" and self.space_after(1)):
                self.error("expected ':' after a mapping key")
            self.i += 1
            if self.at_line_end():
                value = self.block_node(indent)
                if value is None and not self.eof() \
                        and self.col() == indent and self.peek() == "-" \
                        and self.space_after(1):
                    value = self.block_sequence(indent)
            else:
                self.check_indicator()
                if self.peek() == "-" and self.space_after(1):
                    self.error("a block sequence cannot start after a key "
                               "on its line")
                if self.peek() in "[{":
                    value = self.flow_node()
                    if not self.at_line_end():
                        self.error("text after a flow collection")
                else:
                    key_start = self.i
                    if self.peek() not in "'\"" and self.is_mapping_key():
                        self.error("mapping values are not allowed here",
                                   key_start)
                    self.i = key_start
                    value = self.block_scalar_value(indent)
            _hashable(self, key)
            out[key] = value
            self.skip_to_content()
            if self.eof() or self.col() < indent:
                return out
            if self.col() > indent:
                self.error("bad indentation of a mapping entry")
            if self.peek() == "-" and self.space_after(1):
                return out
            if self.s.startswith(("---", "..."), self.i) and indent == 0 \
                    and self.space_after(3):
                return out

    def scalar_key(self):
        if self.peek() in "'\"":
            return self.quoted()
        start = self.i
        text = self.plain(block=True, parent=None)
        return self.resolve(text, start)

    def block_scalar_value(self, parent: int):
        """A scalar in block context; continuation lines must be more
        indented than ``parent``."""
        if self.peek() in "'\"":
            value = self.quoted()
            if not self.at_line_end():
                self.error("text after a quoted scalar")
            return value
        start = self.i
        return self.resolve(self.plain(block=True, parent=parent), start)

    # ----------------------------------------------------------- scalars
    def plain(self, block: bool, parent: int | None) -> str:
        """A plain scalar.  ``parent`` is None for a key (one line only);
        otherwise continuation lines must be indented past it (block) or
        may sit anywhere (flow).  A line break folds to a space, n blank
        lines to n newlines."""
        c = self.peek()
        if c in ("", "\n") or c in "#,[]{}&*!|>'\"%@`" or (
                c in "-?:" and self.space_after(1)):
            self.error(f"a plain scalar cannot start with {c!r}")
        out = self.plain_line(block)
        while parent is not None and self.peek() == "\n":
            nxt = self.continuation(block, parent)
            if nxt is None:
                break
            self.i, blank = nxt
            out += ("\n" * blank if blank else " ") + self.plain_line(block)
        return out

    def plain_line(self, block: bool) -> str:
        """The rest of a plain scalar on this line, trailing blanks cut."""
        start = self.i
        while not self.eof():
            c = self.peek()
            if c == "\n":
                break
            if c == ":" and (self.space_after(1) or (
                    not block and self.peek(1) in _FLOW_IND)):
                break
            if c == "#" and self.i > start and self.s[self.i - 1] in _WS:
                break
            if not block and c in _FLOW_IND:
                break
            self.i += 1
        return self.s[start:self.i].rstrip(_WS)

    def continuation(self, block: bool, parent: int):
        """(position, blank lines skipped) of the line that continues the
        plain scalar ending at this line break, or None."""
        j, blank = self.i, 0
        while True:
            k = self.s.find("\n", j + 1)
            line = self.s[j + 1: len(self.s) if k < 0 else k]
            if line.strip(_WS):
                break
            if k < 0:
                return None
            blank, j = blank + 1, k
        body = line.lstrip(_WS)
        ind = len(line) - len(body)
        if body.startswith("#") or (ind == 0 and body[:3] in ("---", "...")
                                    and body[3:4] in ("", " ", "\t")):
            return None
        if block and (ind <= parent
                      or re.search(r":(\s|$)", body.split(" #")[0])):
            return None
        if not block and body[0] in _FLOW_IND + ":":
            return None
        return j + 1 + ind, blank

    def quoted(self) -> str:
        q = self.peek()
        self.i += 1
        out: List[str] = []
        while True:
            if self.eof():
                self.error("unterminated quoted scalar")
            c = self.peek()
            if q == "'" and c == "'":
                if self.peek(1) == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.peek(1)
                if e in _DQ_ESCAPES:
                    out.append(_DQ_ESCAPES[e])
                    self.i += 2
                elif e in _DQ_HEX:
                    n = _DQ_HEX[e]
                    digits = self.s[self.i + 2: self.i + 2 + n]
                    if len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.error("bad escape in a double-quoted scalar")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                elif e == "\n":
                    self.i += 2
                    self.fold(out, escaped=True)
                else:
                    self.error(f"unknown escape \\{e}")
                continue
            if c in _WS or c == "\n":
                # trailing blanks before a break are dropped
                j = self.i
                while self.s[j:j + 1] in (" ", "\t"):
                    j += 1
                if self.s[j:j + 1] == "\n":
                    self.i = j
                    self.fold(out, escaped=False)
                else:
                    out.append(self.s[self.i:j])
                    self.i = j
                continue
            out.append(c)
            self.i += 1

    def fold(self, out: List[str], escaped: bool):
        """At a line break inside a quoted scalar: one break folds to a
        space, n + 1 breaks to n newlines; leading blanks are dropped."""
        breaks = 0
        while self.peek() in ("\n", " ", "\t"):
            breaks += self.peek() == "\n"
            self.i += 1
        if escaped:  # the escaped break itself joins without a space
            out.append("\n" * breaks)
            return
        if self.col() == 0 and self.s.startswith(("---", "..."), self.i):
            self.error("document marker inside a quoted scalar")
        out.append(" " if breaks == 1 else "\n" * (breaks - 1))

    def resolve(self, text: str, start: int):
        tag = _implicit_tag(text)
        if tag == "str":
            return text
        if tag == "null":
            return None
        if tag == "bool":
            return text.lower() in ("yes", "true", "on")
        if tag == "int":
            return _construct_int(text)
        if tag == "float":
            return _construct_float(text)
        self.error(f"{tag} scalars are not supported ({text!r})", start)

    # -------------------------------------------------------------- flow
    def flow_space(self):
        while not self.eof():
            c = self.peek()
            if c in _WS or c == "\n":
                self.i += 1
            elif c == "#" and self.s[self.i - 1] in _WS + "\n":
                self.skip_comment()
            else:
                return

    def flow_node(self) -> Any:
        self.flow_space()
        self.check_indicator()
        c = self.peek()
        if c == "[":
            return self.flow_sequence()
        if c == "{":
            return self.flow_mapping()
        if c in "'\"":
            return self.quoted()
        if c == "" or c in "]},":
            self.error(f"expected a flow node, found {c or 'the end'!r}")
        start = self.i
        return self.resolve(self.plain(block=False, parent=-1), start)

    def flow_sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.flow_space()
            if self.peek() == "]":
                self.i += 1
                return out
            start = self.i
            item = self.flow_node()
            self.flow_space()
            if self.peek() == ":":
                # a single-pair mapping inside a flow sequence
                self.i += 1
                self.flow_space()
                value = (None if self.peek() in (",", "]")
                         else self.flow_node())
                _hashable(self, item, start)
                item = {item: value}
                self.flow_space()
            out.append(item)
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "]":
                self.error("expected ',' or ']' in a flow sequence")

    def flow_mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.flow_space()
            if self.peek() == "}":
                self.i += 1
                return out
            start = self.i
            key = self.flow_node()
            _hashable(self, key, start)
            self.flow_space()
            value = None
            if self.peek() == ":":
                self.i += 1
                self.flow_space()
                if self.peek() not in (",", "}"):
                    value = self.flow_node()
                    self.flow_space()
            if key == "<<":
                self.error("merge keys are not supported", start)
            out[key] = value
            c = self.peek()
            if c == ",":
                self.i += 1
            elif c != "}":
                self.error("expected ',' or '}' in a flow mapping")


def _hashable(reader: _Reader, key, at: int | None = None):
    if isinstance(key, (dict, list)):
        reader.error("a mapping key must be a scalar", at)


def load(text: str) -> Any:
    """Parse one YAML document of the subset (see the module docstring)."""
    return _Reader(text).document()


# ------------------------------------------------------------------ writer
_ESCAPES_OUT = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t", "\n": "n",
                "\x0b": "v", "\x0c": "f", "\r": "r", "\x1b": "e", '"': '"',
                "\\": "\\", "\x85": "N", "\xa0": "_", "\u2028": "L",
                "\u2029": "P"}


def _plain_allowed(s: str) -> bool:
    """PyYAML's analysis of a one-line printable ASCII scalar in block
    context: may it be written plain?"""
    if not s or s[0] == " " or s[-1] == " ":
        return False
    if s.startswith(("---", "...")):
        return False
    for k, ch in enumerate(s):
        followed_by_ws = k + 1 >= len(s) or s[k + 1] in " \t"
        if k == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                return False
            if ch in "?:-" and followed_by_ws:
                return False
        else:
            if ch == ":" and followed_by_ws:
                return False
            if ch == "#" and s[k - 1] in " \t":
                return False
    return _implicit_tag(s) == "str"


def _double_quoted(s: str) -> str:
    out = ['"']
    for ch in s:
        if ch in _ESCAPES_OUT:
            out.append("\\" + _ESCAPES_OUT[ch])
        elif "\x20" <= ch <= "\x7e":
            out.append(ch)
        elif ch <= "\xff":
            out.append("\\x%02X" % ord(ch))
        elif ch <= "\uffff":
            out.append("\\u%04X" % ord(ch))
        else:
            out.append("\\U%08X" % ord(ch))
    out.append('"')
    return "".join(out)


def _scalar(v) -> str:
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if type(v) is int:
        return str(v)
    if type(v) is float:
        if v != v:
            return ".nan"
        if v == math.inf:
            return ".inf"
        if v == -math.inf:
            return "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if type(v) is str:
        if any(not ("\x20" <= ch <= "\x7e") for ch in v):
            return _double_quoted(v)
        if _plain_allowed(v):
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"yaml_io.dump: cannot represent {type(v).__name__}")


def _is_block(v) -> bool:
    return isinstance(v, (dict, list, tuple)) and len(v) > 0


def _flow_empty(v) -> str:
    return "{}" if isinstance(v, dict) else "[]"


def _node_lines(v, indent: int) -> List[str]:
    if isinstance(v, dict):
        return _mapping_lines(v, indent)
    return _sequence_lines(v, indent)


def _mapping_lines(m: dict, indent: int) -> List[str]:
    pad = " " * indent
    lines = []
    for k, v in m.items():
        key = _scalar(k)
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{key}:")
            lines += _mapping_lines(v, indent + 2)
        elif isinstance(v, (list, tuple)) and v:
            lines.append(f"{pad}{key}:")
            lines += _sequence_lines(v, indent)
        elif isinstance(v, (dict, list, tuple)):
            lines.append(f"{pad}{key}: {_flow_empty(v)}")
        else:
            lines.append(f"{pad}{key}: {_scalar(v)}")
    return lines


def _sequence_lines(seq, indent: int) -> List[str]:
    pad = " " * indent
    lines = []
    for v in seq:
        if _is_block(v):
            inner = _node_lines(v, indent + 2)
            lines.append(f"{pad}- {inner[0][indent + 2:]}")
            lines += inner[1:]
        elif isinstance(v, (dict, list, tuple)):
            lines.append(f"{pad}- {_flow_empty(v)}")
        else:
            lines.append(f"{pad}- {_scalar(v)}")
    return lines


def dump(obj: Any) -> str:
    """``yaml.safe_dump(obj, sort_keys=False)`` for the subset's types."""
    if _is_block(obj):
        return "\n".join(_node_lines(obj, 0)) + "\n"
    if isinstance(obj, (dict, list, tuple)):
        return _flow_empty(obj) + "\n"
    return _scalar(obj) + "\n...\n"
