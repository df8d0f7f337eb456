"""repro_torch.analysis — contract analysis of the port's COLA programs.

The port's counterpart of the reference's ``repro.analysis``. The paper's
claims are properties of the programs themselves: the plan paths never
gather the (K, d) stack, certificates exchange O(d) bytes, the round's hot
path is honest fp32, a round block makes no host round trip. The numeric
tests cannot see any of that — a program that silently all-gathers still
converges. The reference proves them on compiled programs (HLO, jaxprs);
an eager PyTorch program has neither, so this package checks what the
program does when it runs, at three levels:

**1. Comm contracts** (``contracts``) — a ``CommContract`` declares the
collective budget a program is allowed (forbidden kinds, exchange byte /
count caps, psum allowances, gather floors); ``check_comm(report,
contract)`` holds the collective calls and bytes a ``NodeAxis`` counted
(``launch.op_analysis.axis_report``) to it. Contracts come from the
objects that know their own budget — ``CommPlan.contract()`` /
``BlockPlan.contract()`` (backed by ``topo.lowering.comm_budget``) — or
from ``ring_contract`` / ``certificate_contract`` / ``gather_contract``.

**2. Op-trace passes** (``passes``, registry ``PASS_REGISTRY``) over a
``TorchDispatchMode`` trace of the round-block executor's blocks and
rounds:

=======================  ==================================================
``dtype-drift``          every floating result in the block has the
                         declared compute dtype (or a declared wire dtype)
``host-sync-in-block``   no op in a round reads a device value back on the
                         host; on the card ``set_sync_debug_mode("error")``
                         around every round body
``constant-capture``     no host array above a size threshold captured by
                         a round body (it would cross every round)
``in-place``             an in-place round body keeps every state leaf's
                         storage (no silent double-buffering)
``retrace``              a warmed run reports one cache bypass per block-
                         executor call and nothing else, and builds or
                         loads no kernel
``telemetry-carry``      the telemetry counters are device tensors the
                         round advances every round
=======================  ==================================================

**3. Repo AST lints** (``astlint``, registry ``RULES``): the reference's
``frozen-transform``, ``id-in-cache-key`` and ``prng-reuse``, the last one
also over the port's counter streams (``core/streams.py``).

**Drivers** (``drivers``, registry ``DRIVER_REGISTRY``) bind the levels to
the port's programs at the reference's shapes: sim round blocks (plain
and robust), the gossip-DP mix, dist ring / plan / block / block-robust /
wire rounds over ranks, the dense oracle, certificate records (ring and
plan), the gap record, and the executor's retrace check.
``python -m repro_torch.analysis --all`` runs them all plus the AST lints;
``--selftest`` runs the seeded-violation fixtures (``selftest``) proving
each pass fires.

Registration: ``@register_pass`` / ``@register_rule`` /
``@register_driver`` / ``@register_selftest``; the CLI enumerates the
registries. The package imports its modules lazily (``__getattr__``).
"""
from __future__ import annotations

_EXPORTS = {
    # contracts
    "CommContract": "contracts",
    "CommContractViolation": "contracts",
    "check_comm": "contracts",
    "ring_contract": "contracts",
    "certificate_contract": "contracts",
    "gather_contract": "contracts",
    "FORBID_NEIGHBOR_ONLY": "contracts",
    # passes
    "Finding": "passes",
    "PASS_REGISTRY": "passes",
    "register_pass": "passes",
    "OpTrace": "passes",
    "BlockProgram": "passes",
    "trace_ops": "passes",
    "dtype_drift": "passes",
    "host_sync_in_block": "passes",
    "constant_capture": "passes",
    "in_place": "passes",
    "RetraceMonitor": "passes",
    "check_retrace": "passes",
    "telemetry_carry": "passes",
    "trace_passes": "passes",
    "run_block_passes": "passes",
    # astlint
    "RULES": "astlint",
    "register_rule": "astlint",
    "lint_source": "astlint",
    "lint_paths": "astlint",
    # drivers
    "DRIVER_REGISTRY": "drivers",
    "register_driver": "drivers",
    "SkipDriver": "drivers",
    # selftest
    "SELFTESTS": "selftest",
    "run_selftests": "selftest",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(
            f"repro_torch.analysis.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'repro_torch.analysis' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
