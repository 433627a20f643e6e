# S-expression wire codec: the control-plane payload format.
#
# Capability parity with the reference codec (reference:
# src/aiko_services/main/utilities/parser.py:85-227): commands are rendered as
# "(command param ...)", keyword dictionaries as "(a: 1 b: 2)", strings with
# whitespace/parens are double-quoted, and arbitrary binary-safe payloads use
# canonical "len:data" symbols.  parse() and generate() are inverses over the
# supported value domain.
#
# This implementation is written fresh for the TPU framework: a single-pass
# byte-oriented tokenizer (the reference uses char-by-char string slicing) so
# large binary symbols (tensor descriptors) are O(n), plus typed number
# helpers.  The hot tensor path never goes through this codec -- tensors stay
# on device as jax.Array -- so this codec only ever sees control traffic.

from __future__ import annotations

__all__ = [
    "generate", "parse", "parse_list_to_dict", "parse_int", "parse_float",
    "parse_number", "ParseError",
]


class ParseError(ValueError):
    """Raised when a payload is not a well-formed S-expression."""


_QUOTE_NEEDED = set(' \t\r\n()"')


def _ascii_digits(text: str) -> bool:
    """ASCII-only digit check: str.isdigit() accepts unicode digits like
    superscripts that int() rejects, which would make the tokenizer raise
    bare ValueError (and diverge from the native parser)."""
    return bool(text) and all("0" <= ch <= "9" for ch in text)


def _atom_needs_quoting(text: str) -> bool:
    if text == "":
        return True
    if any(ch in _QUOTE_NEEDED for ch in text):
        return True
    # "12:34" would parse as a canonical "len:data" symbol -- quote it so
    # generate() and parse() stay inverses
    colon = text.find(":")
    return colon > 0 and _ascii_digits(text[:colon])


def _generate_value(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if value is None:
        return "()"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, bytes):
        data = value.decode("latin-1")
        return f"{len(data)}:{data}"
    if isinstance(value, dict):
        inner = " ".join(
            f"{key}: {_generate_value(item)}" for key, item in value.items())
        return f"({inner})"
    if isinstance(value, (list, tuple)):
        inner = " ".join(_generate_value(item) for item in value)
        return f"({inner})"
    text = str(value)
    if _atom_needs_quoting(text):
        escaped = text.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    return text


def generate(command: str, parameters=()) -> str:
    """Render a command and its parameters as one S-expression payload."""
    if parameters:
        inner = " ".join(_generate_value(item) for item in parameters)
        return f"({command} {inner})"
    return f"({command})"


class _Tokenizer:
    __slots__ = ("text", "pos", "length")

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.length = len(text)

    def skip_whitespace(self) -> None:
        text, pos, length = self.text, self.pos, self.length
        while pos < length and text[pos] in " \t\r\n":
            pos += 1
        self.pos = pos

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < self.length else ""

    def read_quoted(self) -> str:
        # positioned on the opening quote
        text, pos = self.text, self.pos + 1
        out = []
        while pos < self.length:
            ch = text[pos]
            if ch == "\\" and pos + 1 < self.length:
                out.append(text[pos + 1])
                pos += 2
                continue
            if ch == '"':
                self.pos = pos + 1
                return "".join(out)
            out.append(ch)
            pos += 1
        raise ParseError(f"Unterminated quoted string at offset {self.pos}")

    def read_atom(self) -> str:
        text, pos, length = self.text, self.pos, self.length
        start = pos
        while pos < length and text[pos] not in ' \t\r\n()"':
            ch = text[pos]
            pos += 1
            if ch == ":" and pos > start + 1:
                # Possible canonical symbol "len:data": the run before the
                # colon must be all ASCII digits.
                digits = text[start:pos - 1]
                if _ascii_digits(digits):
                    size = int(digits)
                    end = pos + size
                    if end > length:
                        raise ParseError(
                            f"Canonical symbol overruns payload at {start}")
                    self.pos = end
                    return text[pos:end]
        self.pos = pos
        return text[start:pos]


def _parse_expression(tok: _Tokenizer):
    tok.skip_whitespace()
    ch = tok.peek()
    if ch == "":
        raise ParseError("Unexpected end of payload")
    if ch == "(":
        tok.pos += 1
        items = []
        keyword_mode = False
        while True:
            tok.skip_whitespace()
            ch = tok.peek()
            if ch == "":
                raise ParseError("Unterminated list")
            if ch == ")":
                tok.pos += 1
                break
            items.append(_parse_expression(tok))
        # A list of alternating "name:" keys and values parses to a dict,
        # mirroring the reference keyword-dictionary convention.
        if items and len(items) % 2 == 0:
            keyword_mode = all(
                isinstance(items[i], str) and items[i].endswith(":")
                and len(items[i]) > 1
                for i in range(0, len(items), 2))
        if keyword_mode:
            return {
                items[i][:-1]: items[i + 1] for i in range(0, len(items), 2)}
        return items
    if ch == '"':
        return tok.read_quoted()
    return tok.read_atom()


def _parse_python(payload) -> tuple:
    if isinstance(payload, bytes):
        payload = payload.decode("latin-1")
    tok = _Tokenizer(payload)
    tok.skip_whitespace()
    if tok.peek() == "":
        return "", []
    expression = _parse_expression(tok)
    tok.skip_whitespace()
    if tok.peek() != "":
        raise ParseError(f"Trailing data at offset {tok.pos}")
    if isinstance(expression, str):
        return expression, []
    if isinstance(expression, dict):
        return "", [expression]
    if not expression:
        return "", []
    command = expression[0]
    if not isinstance(command, str):
        return "", expression
    return command, expression[1:]


# Native fast path: the C++ extension (native/sexpr_codec.cpp) parses
# byte-per-char identically; built via `python -m
# aiko_services_tpu.native.build`.  Payloads outside latin-1 (exotic
# unicode atoms) take the Python path.
try:
    from ..native import sexpr_parse_native as _parse_native
    from ..native import install_parse_error as _install_parse_error
except ImportError:  # pragma: no cover
    _parse_native = None
else:
    if _parse_native is not None:
        _install_parse_error(ParseError)


def parse(payload) -> tuple:
    """Parse one S-expression payload into (command, parameters).

    Accepts str or bytes (bytes are latin-1 decoded so canonical symbols are
    binary-safe).  A bare atom parses as (atom, []).  Returns ("", []) for an
    empty payload.
    """
    if _parse_native is not None:
        try:
            return _parse_native(payload)
        except UnicodeEncodeError:
            pass  # non-latin-1 text: python path handles full unicode
    return _parse_python(payload)


def parse_list_to_dict(items) -> dict:
    """Fold a flat [k1 v1 k2 v2 ...] list into a dict (keys lose any ':')."""
    result = {}
    for index in range(0, len(items) - 1, 2):
        key = items[index]
        if isinstance(key, str) and key.endswith(":"):
            key = key[:-1]
        result[key] = items[index + 1]
    return result


def parse_int(text, default=0) -> int:
    try:
        return int(text)
    except (TypeError, ValueError):
        return default


def parse_float(text, default=0.0) -> float:
    try:
        return float(text)
    except (TypeError, ValueError):
        return default


def parse_number(text, default=0):
    """Parse to int when possible, else float, else default."""
    try:
        return int(text)
    except (TypeError, ValueError):
        try:
            return float(text)
        except (TypeError, ValueError):
            return default
