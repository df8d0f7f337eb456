"""Seeded-violation fixtures: prove every pass actually fires.

A checker that silently passes on everything is worse than none, so each
pass has a deliberately broken program, the twins of the reference's
``repro.analysis.selftest``: a float64 round trip inside a round, a
``.item()`` in a round body (on the card ``set_sync_debug_mode`` must
catch it too), a 2 MiB host array captured by a round body, an in-place
body that rebinds its state, an unstable cache key, an all-gather
injected into the plan round, an fp32 payload on a claimed-int8 wire,
counters taken as a constant before the block, and source snippets
violating each AST rule (strings, so that the repository's own AST wall
stays clean). The CLI's ``--selftest`` runs them all and fails if any
seeded violation goes undetected.

Each fixture returns the findings its pass produced on the broken
program; "caught" means at least one finding names the seeded defect.
Fixtures with ``ranks`` run over the drivers' process group
(``drivers.settings``) and skip without one.
"""
from __future__ import annotations

import itertools
import textwrap
from typing import Callable, List

import numpy as np
import torch

from repro_torch.analysis import astlint, contracts, drivers, passes
from repro_torch.analysis.passes import Finding

SELFTESTS: dict = {}


def register_selftest(name: str, *, ranks: int = 0) -> Callable:
    """Register a fixture; ``ranks``: the ranks it needs (0: none; 1: a
    process group of any size)."""
    def deco(fn):
        SELFTESTS[name] = fn
        fn.selftest_name = name
        fn.ranks = ranks
        return fn
    return deco


def _block(step_fn, state, *, in_place: bool = False,
           rounds: int = 2) -> passes.OpTrace:
    """A traced block of ``rounds`` rounds of ``step_fn`` on the
    executor."""
    program = passes.BlockProgram(step_fn=step_fn, state=state, schedule={},
                                  num_rounds=rounds, in_place=in_place)
    return passes.trace_ops(program.run)


def _vec() -> torch.Tensor:
    return torch.zeros((4,), device=drivers._device())


def _of(findings: list, name: str) -> List[Finding]:
    return [f for f in findings if f.pass_name == name]


@register_selftest("dtype-drift")
def seeded_dtype_drift() -> List[Finding]:
    """A silent f32 -> f64 -> f32 round trip inside the round."""
    trace = _block(lambda st, _c, _s: (st.to(torch.float64) * 2.0)
                   .to(torch.float32), _vec())
    return _of(passes.trace_passes(trace, where="selftest:f64-upcast"),
               "dtype-drift")


@register_selftest("host-sync-in-block")
def seeded_host_sync() -> List[Finding]:
    """A forgotten ``.item()`` inside the round body. On the card the
    finding must come from ``set_sync_debug_mode("error")``, which stops
    the run at the sync."""
    trace = _block(lambda st, _c, _s: st + st.sum().item(), _vec())
    found = passes.host_sync_in_block(trace, where="selftest:item")
    if drivers._device().type == "cuda":
        found = [f for f in found if "set_sync_debug_mode" in f.message]
    return found


@register_selftest("constant-capture")
def seeded_constant_capture() -> List[Finding]:
    """A 2 MiB host array closed over by the round body."""
    big = np.ones((1 << 19,), np.float32)
    trace = _block(lambda st, _c, _s: st + float(big[0]), _vec())
    return passes.constant_capture(trace, max_bytes=1 << 20,
                                   where="selftest:2MiB-capture")


@register_selftest("in-place")
def seeded_in_place() -> List[Finding]:
    """An in-place body that returns a new tensor: the state is silently
    double-buffered."""
    trace = _block(lambda st, _c, _s, _stopped: st * 1.0, _vec(),
                   in_place=True)
    return passes.in_place(trace, where="selftest:rebound-state")


@register_selftest("retrace")
def seeded_retrace() -> List[Finding]:
    """An unstable cache key (fresh every call): the warmed re-run must
    surface as a cache miss."""
    from repro_torch.core import executor
    counter = itertools.count()

    def run():
        executor._cache_event(("selftest-retrace", next(counter)), "miss")

    return passes.check_retrace(run, where="selftest:unstable-key")


@register_selftest("comm-contract", ranks=1)
def seeded_all_gather() -> List[Finding]:
    """An all-gather injected into the plan round (K = 4 nodes over the
    group's ranks; the per-node plan at 4 ranks): the counted collectives
    must violate the plan's neighbor-only contract."""
    from repro_torch.core import topology as topo
    from repro_torch.core.cola import ColaConfig
    axis = drivers._SETTINGS["axis"]
    if axis is None or 4 % axis.size:
        raise drivers.SkipDriver("needs a group of 1, 2 or 4 ranks")
    prob = drivers._lasso()
    report, plan, _, _ = drivers.dist_round(
        prob, topo.torus_2d(2, 2), ColaConfig(kappa=1.0), axis, comm="plan",
        inject=lambda ax, _st, new: ax.all_gather(new.v_stack))
    try:
        contracts.check_comm(report, plan.contract(prob.d))
    except contracts.CommContractViolation as e:
        if "forbidden all-gather" in str(e):
            return [Finding("comm-contract", str(e),
                            where="selftest:injected-all-gather")]
    return []


@register_selftest("comm-contract-wire", ranks=4)
def seeded_fp32_leak() -> List[Finding]:
    """An fp32 payload exchanged across a claimed-int8 wire: the narrow
    contract's byte cap must catch the wide leak (K = 8 over 4 ranks)."""
    def leak(axis, st, _new):
        m = axis.size
        axis.permute(st.v_stack, [(i, (i + 1) % m) for i in range(m)])

    findings, _, _, _, _ = drivers._dist_wire(
        "int8", "selftest:fp32-on-int8-wire", inject=leak)
    return [f for f in findings if "collective-permute moves" in f.message]


@register_selftest("telemetry-carry")
def seeded_telemetry_constant() -> List[Finding]:
    """Counters taken as a constant before the block: the "on" body
    returns a precomputed row and never advances the carried counters,
    so the recorded totals freeze at their initial values."""
    from repro_torch.core.cola import ColaState
    from repro_torch.obs import counters
    dev = drivers._device()
    state = ColaState(x_parts=torch.zeros((2, 3), device=dev),
                      v_stack=torch.zeros((2, 4), device=dev),
                      counters=counters.init_counters(2, dev))
    row = torch.zeros((3,), device=dev)  # the seeded bug
    step_off = lambda st, _c, _s: st._replace(v_stack=st.v_stack + 1.0)

    def trace(step, with_aux):
        return passes.trace_ops(passes.BlockProgram(
            step_fn=step, state=state, schedule={}, num_rounds=4,
            with_aux=with_aux).run)

    off = trace(step_off, False)
    on = trace(lambda st, c, s: (step_off(st, c, s), {"obs": row}), True)
    return passes.telemetry_carry(off, on, where="selftest:constant-counter")


_AST_VIOLATIONS = {
    "frozen-transform": """
        class Mutable:
            def apply(self, sched, ctx):
                sched["w"] = None
        """,
    "id-in-cache-key": """
        def build_driver(prob, build):
            return cached_driver((id(prob), 3), build)
        """,
    "prng-reuse": """
        def sample(key):
            a = jax.random.normal(key, (3,))
            b = jax.random.uniform(key, (3,))
            return a, b
        """,
}

# the port's counter streams: two draws of one key at one offset
_STREAM_REUSE = """
    def draw(key, shape, device):
        a = streams.uniform(key, shape, device)
        b = streams.bits(key, shape, device)
        return a, b
    """


def _seeded_ast(rule: str, src: str) -> Callable[[], List[Finding]]:
    def fixture() -> List[Finding]:
        return [f for f in astlint.lint_source(textwrap.dedent(src),
                                               f"selftest:{rule}")
                if f.pass_name == rule]
    fixture.__doc__ = f"Source snippet violating the ``{rule}`` AST rule."
    return fixture


for _rule, _src in _AST_VIOLATIONS.items():
    register_selftest(f"ast-{_rule}")(_seeded_ast(_rule, _src))
register_selftest("ast-prng-reuse-streams")(
    _seeded_ast("prng-reuse", _STREAM_REUSE))


def caught_row(name: str, result: dict) -> tuple:
    """``(name, caught, detail)`` from ``drivers.run_one``'s result:
    caught None for a skip; a crash is not caught."""
    if result["status"] in ("skip", "n/a"):
        return name, None, result["detail"]
    if result["status"] == "crash":
        return name, False, "fixture crashed:\n" + result["detail"]
    found = result["findings"]
    return name, bool(found), (found[0] if found else
                               "pass produced NO findings on its seeded "
                               "violation")


def run_selftests(names=None) -> List[tuple]:
    """Run the seeded violations in this process (under the drivers'
    current settings); ``(name, caught, detail)`` rows, ``caught`` None
    when the fixture's rank needs are not met."""
    return [caught_row(name, drivers.run_one(SELFTESTS[name]))
            for name in (names or SELFTESTS)]
