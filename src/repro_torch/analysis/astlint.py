"""Repo-specific AST lints over the source tree.

Three rules, each encoding a correctness invariant the runtime relies on
but Python cannot enforce:

* ``frozen-transform`` — every attack-scenario / schedule transform (a
  class registered with ``@register_scenario`` or defining
  ``apply(self, sched, ctx)``) must be a ``@dataclasses.dataclass``
  with ``frozen=True``: transforms ride compiled-driver cache keys via
  field hashing, and a mutable transform could change after its key was
  computed.
* ``id-in-cache-key`` — no ``id()`` / ``hash()`` inside a ``cache_key=``
  argument, a ``cached_driver``/``fingerprint`` call, or a
  ``cache_token`` method body: an address-based key silently reuses a
  stale compiled driver when the allocator recycles the address (the
  exact bug PR 2 fixed — this rule keeps it fixed).
* ``prng-reuse`` — a PRNG key consumed by two ``jax.random`` samplers in
  the same straight-line block without an intervening
  ``split``/``fold_in`` rebind produces correlated draws; rebind first.
  The port's own counter streams (``core/streams.py``) obey the same
  rule: two of ``streams.bits`` / ``uniform`` / ``normal`` on one key
  Name with the same ``offset`` (or none) draw the same values; fold the
  key or move the offset first.

The port's copy of the reference's ``repro.analysis.astlint``: on a source
without ``streams`` draws it gives the reference's findings, word for word.
Rules register in ``RULES`` via ``@register_rule`` and run over parsed
modules — no imports of the linted code, so they also run on files with
unsatisfied dependencies.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Callable, Iterable, List

from repro_torch.analysis.passes import Finding

RULES: dict = {}


def register_rule(name: str) -> Callable:
    def deco(fn):
        RULES[name] = fn
        fn.rule_name = name
        return fn
    return deco


def _call_name(node: ast.AST) -> str:
    """Trailing name of a call target: ``jax.random.normal`` -> normal."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_frozen_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        if isinstance(dec, ast.Call) and _call_name(dec.func) == "dataclass":
            for kw in dec.keywords:
                if kw.arg == "frozen" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is True:
                    return True
    return False


@register_rule("frozen-transform")
def frozen_transform(tree: ast.Module, path: str) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        registered = any(
            isinstance(dec, ast.Call)
            and _call_name(dec.func) == "register_scenario"
            for dec in node.decorator_list)
        has_apply = any(
            isinstance(st, ast.FunctionDef) and st.name == "apply"
            and [a.arg for a in st.args.args][:3] == ["self", "sched", "ctx"]
            for st in node.body)
        if (registered or has_apply) and not _is_frozen_dataclass(node):
            why = "registered scenario" if registered \
                else "schedule transform (defines apply(self, sched, ctx))"
            out.append(Finding(
                "frozen-transform",
                f"class {node.name} is a {why} but not a frozen dataclass: "
                "transforms are hashed into compiled-driver cache keys and "
                "must be immutable", f"{path}:{node.lineno}"))
    return out


def _id_hash_calls(node: ast.AST) -> Iterable[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id in ("id", "hash"):
            yield sub


@register_rule("id-in-cache-key")
def id_in_cache_key(tree: ast.Module, path: str) -> List[Finding]:
    out: List[Finding] = []

    def flag(call: ast.Call, ctx: str) -> None:
        out.append(Finding(
            "id-in-cache-key",
            f"{call.func.id}() inside {ctx}: address-based keys alias when "
            "the allocator recycles addresses — use executor.fingerprint() "
            "(content-addressed) instead", f"{path}:{call.lineno}"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if name in ("cached_driver", "fingerprint"):
                for arg in list(node.args) + [kw.value for kw in
                                              node.keywords]:
                    for call in _id_hash_calls(arg):
                        flag(call, f"a {name}() argument")
        if isinstance(node, ast.keyword) and node.arg == "cache_key":
            for call in _id_hash_calls(node.value):
                flag(call, "a cache_key= argument")
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == "cache_token":
            for st in node.body:
                for call in _id_hash_calls(st):
                    flag(call, "a cache_token() body")
    return out


# jax.random samplers that CONSUME a key (split/fold_in derive new ones)
_SAMPLERS = frozenset({
    "normal", "uniform", "bernoulli", "randint", "truncated_normal",
    "permutation", "choice", "gamma", "exponential", "laplace", "bits",
    "categorical", "gumbel", "dirichlet", "beta", "poisson", "rademacher"})


def _stmt_calls(stmt: ast.stmt) -> Iterable[ast.Call]:
    """Calls in ``stmt``'s own expressions, NOT descending into nested
    statement lists — an ``if``'s branches, a nested ``def``'s body — which
    are separate straight-line blocks (scanned on their own) rather than
    sequential consumptions."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            yield node
        for value in ast.iter_child_nodes(node):
            if isinstance(value, ast.stmt) and value is not stmt:
                continue
            stack.append(value)


def _assigned_names(stmt: ast.stmt) -> set:
    names = set()
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.For)):
        targets = [stmt.target]
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                names.add(sub.id)
    return names


# the port's counter-stream draws (core/streams.py): (key, shape, device,
# offset=0), ``normal`` without an offset
_STREAM_DRAWS = frozenset({"bits", "uniform", "normal"})


def _stream_offset(call: ast.Call) -> str:
    """The ``offset`` a streams draw starts at, as source (0 if absent)."""
    for kw in call.keywords:
        if kw.arg == "offset":
            return ast.dump(kw.value)
    if len(call.args) > 3:
        return ast.dump(call.args[3])
    return ast.dump(ast.Constant(0))


def _draw_key(call: ast.Call):
    """(key Name, offset) of a ``jax.random`` sampler or a ``streams``
    draw on a Name key, else None. jax samplers carry no offset."""
    if not (call.args and isinstance(call.args[0], ast.Name)):
        return None
    name, dotted = _call_name(call.func), _dotted(call.func)
    if name in _SAMPLERS and "random" in dotted:
        return call.args[0].id, None
    if name in _STREAM_DRAWS and "streams" in dotted.split("."):
        return call.args[0].id, _stream_offset(call)
    return None


@register_rule("prng-reuse")
def prng_reuse(tree: ast.Module, path: str) -> List[Finding]:
    """Same key Name consumed by >= 2 ``jax.random`` samplers (or two
    ``streams`` draws at one offset) in one straight-line statement block
    with no rebind in between."""
    out: List[Finding] = []
    for node in ast.walk(tree):
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if not isinstance(block, list):
                continue
            used: dict = {}
            for stmt in block:
                if not isinstance(stmt, ast.stmt):
                    continue
                rebound = _assigned_names(stmt)
                used = {k: v for k, v in used.items() if k[0] not in rebound}
                for call in _stmt_calls(stmt):
                    key = _draw_key(call)
                    if key is None:
                        continue
                    if key in used:
                        out.append(Finding(
                            "prng-reuse",
                            f"key `{key[0]}` consumed by "
                            f"{_dotted(call.func)} was already consumed at "
                            f"line {used[key]} without a split/fold_in "
                            "rebind: the draws are identical/correlated",
                            f"{path}:{call.lineno}"))
                    used[key] = call.lineno
    return out


def lint_source(text: str, path: str = "<string>") -> List[Finding]:
    """Run every registered rule over one module's source."""
    tree = ast.parse(text, filename=path)
    out: List[Finding] = []
    for rule in RULES.values():
        out.extend(rule(tree, path))
    return out


def lint_paths(paths: Iterable) -> List[Finding]:
    """Run every rule over all ``.py`` files under ``paths``."""
    out: List[Finding] = []
    for root in paths:
        root = pathlib.Path(root)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            out.extend(lint_source(f.read_text(), str(f)))
    return out
