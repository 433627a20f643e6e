# Tensor-spec grammar: the typed language of pipeline ports.
#
# The definition layer's port "type" field was a vestigial string
# ("any") the engine never read.  The static analyzer gives it a real
# grammar so shape/dtype flow can be PROVEN at definition time, the way
# an MLIR verifier proves an IR module well-typed before any pass runs:
#
#   type     := opaque | tensor
#   opaque   := "any" | "str" | "bytes" | "int" | "float" | "bool"
#             | "dict" | "list"
#   tensor   := dtype "[" dims? "]"
#   dtype    := "f32" | "f16" | "bf16" | "f64" | "i8" | "i16" | "i32"
#             | "i64" | "u8" | "u16" | "u32" | "u64" | "bool"
#             (long forms "float32", "int32", ... are accepted too)
#   dims     := dim ("," dim)*
#   dim      := INT          a fixed size, checked exactly
#             | SYMBOL       a symbolic size ("b", "t", "seq"): bound to
#                            one size per graph -- two ports binding the
#                            same symbol must agree
#             | "*" | "?"    wildcard: any size, no binding
#
# Examples: "f32[b,3,224,224]"  "i32[b,t]"  "f32[]" (a scalar)
#           "bf16[b,*,d]"       "str"       "any"
#
# Symbols are scoped to ONE pipeline definition: "b" in the source's
# output and "b" in the detector's input are the same batch.  The
# analyzer binds a symbol the first time it meets a fixed size and
# reports AIKO205 when a later port disagrees.

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = [
    "PortSpec", "SpecError", "parse_port_type", "check_flow",
    "resolve_dims", "OPAQUE_KINDS", "DTYPE_ALIASES",
]


class SpecError(ValueError):
    """A port "type" string that is not in the tensor-spec grammar."""


# Short dtype mnemonics -> canonical jax/numpy dtype names.  Long forms
# map to themselves so either spelling round-trips.
DTYPE_ALIASES = {
    "f16": "float16", "f32": "float32", "f64": "float64",
    "bf16": "bfloat16",
    "i8": "int8", "i16": "int16", "i32": "int32", "i64": "int64",
    "u8": "uint8", "u16": "uint16", "u32": "uint32", "u64": "uint64",
    "bool": "bool",
}
DTYPE_ALIASES.update({name: name for name in list(DTYPE_ALIASES.values())})

# Non-tensor port kinds: the analyzer treats them as opaque values that
# flow by name only (host strings, overlay dicts, detection pytrees).
# "any" is the universal wildcard -- compatible with everything, which
# is also why it proves nothing.
OPAQUE_KINDS = ("any", "str", "bytes", "int", "float", "bool", "dict",
                "list")

_SYMBOL_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_TENSOR_RE = re.compile(r"^(?P<dtype>[A-Za-z0-9_]+)\[(?P<dims>[^\]]*)\]$")


@dataclass(frozen=True)
class PortSpec:
    """One parsed port type: either an opaque kind or a tensor spec."""

    kind: str                 # "tensor" or one of OPAQUE_KINDS
    dtype: str | None = None  # canonical dtype name (tensor only)
    dims: tuple | None = None  # int | str symbol | "*" per axis
    raw: str = "any"

    @property
    def is_tensor(self) -> bool:
        return self.kind == "tensor"

    @property
    def is_any(self) -> bool:
        return self.kind == "any"

    def __str__(self):
        return self.raw


ANY = PortSpec(kind="any", raw="any")


def parse_port_type(text) -> PortSpec:
    """Parse one port "type" string; raises SpecError with the exact
    grammar problem (the message becomes the AIKO201 diagnostic)."""
    if text is None:
        return ANY
    raw = str(text).strip()
    if not raw:
        return ANY
    lowered = raw.lower()
    if lowered in OPAQUE_KINDS:
        return PortSpec(kind=lowered, raw=lowered)
    match = _TENSOR_RE.match(raw)
    if not match:
        if "[" in raw or "]" in raw:
            raise SpecError(
                f"type {raw!r} is not a tensor spec: expected "
                f"dtype[dim,...] like f32[b,3,224,224]")
        raise SpecError(
            f"type {raw!r} is not a known port type: expected one of "
            f"{OPAQUE_KINDS} or a tensor spec like f32[b,3,224,224]")
    dtype_token = match.group("dtype").lower()
    dtype = DTYPE_ALIASES.get(dtype_token)
    if dtype is None:
        raise SpecError(
            f"type {raw!r} names unknown dtype {dtype_token!r}; known: "
            f"{sorted(set(DTYPE_ALIASES))}")
    dims_text = match.group("dims").strip()
    dims = []
    if dims_text:
        for token in dims_text.split(","):
            token = token.strip()
            if not token:
                raise SpecError(f"type {raw!r} has an empty dimension")
            if token in ("*", "?"):
                dims.append("*")
            elif token.lstrip("-").isdigit():
                size = int(token)
                if size <= 0:
                    raise SpecError(
                        f"type {raw!r}: dimension {token} must be a "
                        f"positive size")
                dims.append(size)
            elif _SYMBOL_RE.match(token):
                dims.append(token)
            else:
                raise SpecError(
                    f"type {raw!r}: dimension {token!r} is not an int, "
                    f"a symbol, or '*'")
    return PortSpec(kind="tensor", dtype=dtype, dims=tuple(dims), raw=raw)


def check_flow(producer: PortSpec, consumer: PortSpec,
               bindings: dict) -> list:
    """Check one producer->consumer edge; returns (code, message)
    problems.  `bindings` is the graph-wide symbol table
    symbol -> (size, where) -- symbols bind on first concrete contact
    and every later contact must agree (AIKO205)."""
    if not producer.is_tensor or not consumer.is_tensor:
        # "any" matches everything; a tensor flowing into a non-any
        # opaque port (or vice versa) clashes; two opaque kinds are
        # compatible -- host elements legitimately hand a str where a
        # list[str] arrives (per-row batching), so Python duck-typing
        # is the ground truth between opaque ports
        if producer.is_any or consumer.is_any:
            return []
        if producer.is_tensor != consumer.is_tensor:
            return [("AIKO202",
                     f"producer type {producer.raw!r} is not consumable "
                     f"as {consumer.raw!r}")]
        return []
    problems = []
    if producer.dtype != consumer.dtype:
        problems.append((
            "AIKO202",
            f"dtype clash: producer {producer.raw!r} vs consumer "
            f"{consumer.raw!r}"))
    if len(producer.dims) != len(consumer.dims):
        problems.append((
            "AIKO203",
            f"rank mismatch: producer {producer.raw!r} is rank "
            f"{len(producer.dims)}, consumer {consumer.raw!r} is rank "
            f"{len(consumer.dims)}"))
        return problems
    for axis, (left, right) in enumerate(
            zip(producer.dims, consumer.dims)):
        problems.extend(_check_dim(axis, left, right, bindings))
    return problems


def _check_dim(axis: int, left, right, bindings: dict) -> list:
    """Unify one dimension pair under the graph symbol table."""
    if left == "*" or right == "*":
        return []
    if isinstance(left, int) and isinstance(right, int):
        if left != right:
            return [("AIKO204",
                     f"axis {axis}: producer size {left} != consumer "
                     f"size {right}")]
        return []
    problems = []
    for symbol, size in ((left, right), (right, left)):
        if isinstance(symbol, str) and isinstance(size, int):
            bound = bindings.get(symbol)
            if bound is None:
                bindings[symbol] = (size, f"axis {axis}")
            elif bound[0] != size:
                problems.append((
                    "AIKO205",
                    f"axis {axis}: symbol {symbol!r} already bound to "
                    f"{bound[0]} ({bound[1]}) but meets size {size} "
                    f"here"))
            break
    # symbol-vs-symbol: compatible; distinct names stay independent
    return problems


def resolve_dims(spec: PortSpec, bindings: dict,
                 default_symbol_size: int = 2) -> tuple | None:
    """Concrete shape for a tensor spec: symbols resolve through
    `bindings` (falling back to `default_symbol_size`), wildcards to the
    default.  None for opaque specs."""
    if not spec.is_tensor:
        return None
    shape = []
    for dim in spec.dims:
        if isinstance(dim, int):
            shape.append(dim)
        elif dim == "*":
            shape.append(default_symbol_size)
        else:
            bound = bindings.get(dim)
            shape.append(bound[0] if bound else default_symbol_size)
    return tuple(shape)
