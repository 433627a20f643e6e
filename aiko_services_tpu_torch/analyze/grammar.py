# Shared directive-grammar core: ONE spec-checking engine behind every
# operator-facing mini-grammar.
#
# PR 3 (fault injection) and PR 4 (gateway admission policy) each grew
# a hand-rolled `key=value;...` parser, and the definition layer
# validates `on_error`/`max_retries`/... with ad-hoc checks; each had
# its own error style and none was checkable OFFLINE (you had to
# construct the object to find the typo).  This module folds them
# behind one core:
#
#   Field            one typed value: coercion + range + choices with
#                    uniform error messages
#   DirectiveGrammar a `;`-separated directive string: bare key=value
#                    options, `head(:key=value)*` directives (the fault
#                    spec shape), and `prefix:tail=value` entries (the
#                    policy's `bucket:P=rate/burst`)
#   check()          the lint surface: the same validation as parse(),
#                    returning problems instead of raising, so
#                    `aiko lint` checks a spec without building the
#                    injector/policy it describes
#
# GrammarError subclasses ValueError, so existing callers that caught
# ValueError keep working unchanged.

from __future__ import annotations

__all__ = ["Field", "DirectiveGrammar", "GrammarError",
           "ParsedDirectives", "split_directives"]


class GrammarError(ValueError):
    """One grammar violation.  `kind` separates "unknown directive/key"
    (the AIKO404 shape) from a bad value (AIKO401/402/403)."""

    def __init__(self, message: str, kind: str = "value"):
        super().__init__(message)
        self.kind = kind


_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off", "")


class Field:
    """One typed value in a grammar: kind in int|float|str|flag, with
    optional bounds and choices.  coerce() accepts wire strings or
    already-typed values and raises GrammarError with a message naming
    the grammar, the key, and the exact problem."""

    __slots__ = ("kind", "minimum", "maximum", "choices", "help")

    def __init__(self, kind: str = "str", minimum=None, maximum=None,
                 choices=None, help: str = ""):
        self.kind = kind
        self.minimum = minimum
        self.maximum = maximum
        self.choices = tuple(choices) if choices else None
        self.help = help

    def coerce(self, grammar_name: str, key: str, value):
        try:
            if self.kind == "int":
                value = int(value)
            elif self.kind == "float":
                value = float(value)
            elif self.kind == "flag":
                if isinstance(value, str):
                    lowered = value.strip().lower()
                    if lowered in _TRUTHY:
                        value = True
                    elif lowered in _FALSY:
                        value = False
                    else:
                        raise ValueError(value)
                else:
                    value = bool(value)
            else:
                value = str(value)
        except (TypeError, ValueError):
            raise GrammarError(
                f"{grammar_name}: {key}={value!r} is not a valid "
                f"{self.kind}") from None
        if self.choices is not None:
            comparable = (value.lower() if isinstance(value, str)
                          else value)
            if comparable not in self.choices:
                raise GrammarError(
                    f"{grammar_name}: {key} must be one of "
                    f"{self.choices}, got {value!r}")
            return comparable
        if self.minimum is not None and value < self.minimum:
            raise GrammarError(
                f"{grammar_name}: {key}={value} is below the minimum "
                f"{self.minimum}")
        if self.maximum is not None and value > self.maximum:
            raise GrammarError(
                f"{grammar_name}: {key}={value} is above the maximum "
                f"{self.maximum}")
        return value


def split_directives(spec: str, separator: str = ";") -> list:
    return [part.strip() for part in str(spec).split(separator)
            if part.strip()]


class ParsedDirectives:
    """parse() result: coerced bare options, head directives with
    their coerced args, and prefixed entries."""

    __slots__ = ("options", "directives", "prefixed")

    def __init__(self):
        self.options: dict = {}
        self.directives: list = []   # (head, {key: value})
        self.prefixed: list = []     # (prefix, tail, value)


class DirectiveGrammar:
    """Declarative spec for one `;`-separated directive grammar.

    options    bare `key=value` entries (gateway policy keys; the fault
               spec's `seed`)
    heads      `head(:key=value)*` directives: head word -> arg Field
               table (the fault spec's injection points); unknown heads
               raise with `unknown_head_message` ("unknown fault
               point ..." keeps the historical wording)
    prefixes   `prefix:tail=value` entries, parsed by a callable
               (tail, value) -> parsed, raising GrammarError/ValueError
               on bad input (the policy's `bucket:P=rate/burst`)
    """

    def __init__(self, name: str, options: dict | None = None,
                 heads: dict | None = None, prefixes: dict | None = None,
                 unknown_head_message: str | None = None):
        self.name = name
        self.options = dict(options or {})
        self.heads = dict(heads or {})
        self.prefixes = dict(prefixes or {})
        self.unknown_head_message = unknown_head_message

    # -- parsing -------------------------------------------------------

    def parse(self, spec) -> ParsedDirectives:
        """Parse a directive string (or an options dict) with full
        validation; raises GrammarError on the first problem."""
        parsed = ParsedDirectives()
        if spec is None or spec == "":
            return parsed
        if isinstance(spec, dict):
            for key, value in spec.items():
                self._parse_option(parsed, str(key), value)
            return parsed
        for part in split_directives(spec):
            tokens = part.split(":")
            head = tokens[0].strip()
            if "=" in head:
                self._parse_option(parsed, *self._split_kv(part))
                continue
            if head in self.prefixes and len(tokens) > 1:
                tail, _, value = ":".join(tokens[1:]).partition("=")
                try:
                    parsed.prefixed.append(
                        (head, tail.strip(),
                         self.prefixes[head](tail.strip(),
                                             value.strip())))
                except GrammarError:
                    raise
                except (TypeError, ValueError) as error:
                    raise GrammarError(
                        f"{self.name}: bad {head} directive "
                        f"{part!r}: {error}") from None
                continue
            if head in self.heads:
                fields = self.heads[head]
                args = {}
                for token in tokens[1:]:
                    key, _, value = token.partition("=")
                    key = key.strip()
                    field = fields.get(key)
                    if field is None:
                        raise GrammarError(
                            f"{self.name}: directive {head!r} has "
                            f"unknown key {key!r} (valid: "
                            f"{sorted(fields)})", kind="unknown")
                    args[key] = field.coerce(self.name, key,
                                             value.strip())
                parsed.directives.append((head, args))
                continue
            if self.heads and self.unknown_head_message:
                raise GrammarError(
                    f"{self.unknown_head_message} {head!r} "
                    f"(valid: {tuple(self.heads)})", kind="unknown")
            raise GrammarError(
                f"{self.name}: directive {part!r} is not key=value",
                kind="unknown")
        return parsed

    def _split_kv(self, part: str) -> tuple:
        key, sep, value = part.partition("=")
        if not sep:
            raise GrammarError(
                f"{self.name}: directive {part!r} is not key=value",
                kind="unknown")
        return key.strip(), value.strip()

    def _parse_option(self, parsed: ParsedDirectives, key: str,
                      value) -> None:
        if key.startswith(tuple(f"{prefix}:" for prefix
                                in self.prefixes)):
            # dict-shaped prefixed entry ({"bucket:2": (10, 4)})
            prefix, _, tail = key.partition(":")
            try:
                parsed.prefixed.append(
                    (prefix, tail, self.prefixes[prefix](tail, value)))
            except GrammarError:
                raise
            except (TypeError, ValueError) as error:
                raise GrammarError(
                    f"{self.name}: bad {prefix} entry {key!r}: "
                    f"{error}") from None
            return
        field = self.options.get(key)
        if field is None:
            raise GrammarError(
                f"{self.name}: unknown directive {key!r} (valid: "
                f"{sorted(self.options)})", kind="unknown")
        parsed.options[key] = field.coerce(self.name, key, value)

    # -- the lint surface ----------------------------------------------

    def check(self, spec, value_code: str,
              unknown_code: str = "AIKO404") -> list:
        """Validate without constructing: every problem as a
        (code, message) pair -- unknown directives/keys map to
        `unknown_code`, bad values to `value_code`."""
        problems = []
        if spec is None or spec == "":
            return problems
        if isinstance(spec, dict):
            items = [{key: value} for key, value in spec.items()]
        else:
            items = split_directives(spec)
        for part in items:
            try:
                self.parse(part)
            except GrammarError as error:
                problems.append(
                    (unknown_code if error.kind == "unknown"
                     else value_code, str(error)))
            except ValueError as error:
                problems.append((value_code, str(error)))
        return problems
