"""Lint passes over the port's round-block programs.

The reference walks a closed jaxpr; an eager PyTorch program has none, so
its counterpart is an **op trace**: ``trace_ops(fn, *args)`` runs ``fn``
under a ``TorchDispatchMode`` and records every aten op it executes, with
its operands' and results' shapes, dtypes and devices and the path of
regions it ran in. The round-block executor (``core/executor.py``) marks
its ``"block"`` and ``"round"`` regions, the part ``scan`` / ``while`` play
in a jaxpr, and the trace wraps each round body the executor calls in a
``"step"`` region. Kernels launched through ctypes never reach the
dispatcher: the trace sees the tensors that go into and out of their
wrappers and lists their launches by name and region (``OpTrace.launches``,
from the wrappers' ``LAUNCHES`` counters); it invents none of their ops.

The passes, each under ``@register_pass``:

* ``dtype-drift`` — every floating result inside the block has the
  declared compute dtype. The narrow dtypes of a quantized payload are an
  input of the pass (``wire_dtypes``), never an exemption written into it.
* ``host-sync-in-block`` (the reference's ``host-callback-in-scan``) — no
  op inside a round reads a device value back on the host:
  ``_local_scalar_dense`` (``.item()``, ``bool(t)``), ``nonzero``,
  ``masked_select``, ``unique``, boolean indexing, ``equal``, copies to
  the CPU. On the card the trace also arms
  ``torch.cuda.set_sync_debug_mode("error")`` around every round body
  (never around the executor's once-per-block stop-flag read), which
  catches what the dispatcher cannot see, such as ``.numpy()`` or a copy
  from pageable host memory.
* ``constant-capture`` — a round body that closes over a host array above
  ``max_bytes`` (a numpy array, or a CPU tensor while the run is on
  another device) moves it again every round. It is found through the
  closures and ``functools.partial`` arguments of the round body; it
  belongs in the executor's schedule or context.
* ``in-place`` (the reference's ``donation``) — an ``in_place`` round body
  keeps the storage of every state leaf: the same ``data_ptr()`` before and
  after each round, or the state is silently double-buffered.
* ``retrace`` — the port caches no driver; every ``run_round_blocks`` call
  reports one ``"bypass"`` event. A warmed run must report no other cache
  event, exactly one bypass per block-executor call, and build or load no
  kernel library (``kernels/build.py``'s ``BUILD_COUNTS`` and loaded set).
* ``telemetry-carry`` — with telemetry on, the counters are device tensors
  of the carried state that the round advances every round, and the
  block returns more per-round aux entries than its telemetry-off twin.

``run_block_passes`` runs the first four over one block program.
"""
from __future__ import annotations

import dataclasses
import functools
import types
from typing import Any, Callable, Iterator, List, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import executor


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation: which pass, where, and what went wrong."""

    pass_name: str
    message: str
    where: str = ""

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.pass_name}{loc}: {self.message}"


PASS_REGISTRY: dict = {}


def register_pass(name: str) -> Callable:
    """Register a pass under ``name`` (listed by the CLI; see the module
    docstring for the contract each built-in pass enforces)."""
    def deco(fn):
        PASS_REGISTRY[name] = fn
        fn.pass_name = name
        return fn
    return deco


# -- the op trace -----------------------------------------------------------

class TensorMeta(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    device: torch.device
    nbytes: int           # the tensor as passed: a view counts its elements


class OpRecord(NamedTuple):
    name: str             # the aten overload, e.g. "aten.mm.default"
    path: tuple           # enclosing regions, outermost first
    inputs: tuple         # TensorMeta of each tensor operand
    outputs: tuple        # TensorMeta of each tensor result
    view: bool            # the result aliases an operand: no data moves
    flops: float

    @property
    def traffic(self) -> int:
        """Bytes the op moves: its operands plus its results (a view or an
        allocation moves none)."""
        if self.view or self.name.split(".")[1] in _NO_WORK:
            return 0
        return sum(m.nbytes for m in self.inputs + self.outputs)


# ops that allocate or read a scalar back: no arithmetic, no traffic
_NO_WORK = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "_local_scalar_dense",
                      "lift_fresh"})


def _meta(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(tuple(t.shape), t.dtype, t.device,
                      t.numel() * t.element_size())


def _contraction(base: str, args) -> int | None:
    """The contraction length of a matmul-family op, else None."""
    if base in ("mm", "bmm", "mv"):
        return args[0].shape[-1]
    if base in ("addmm", "baddbmm", "addmv"):
        return args[1].shape[-1]
    if base == "addbmm":
        return args[1].shape[0] * args[1].shape[-1]
    if base in ("dot", "vdot"):
        return args[0].numel()
    return None


def op_flops(base: str, args, outputs) -> float:
    """2 x output elements x contraction for the matmul family (the
    reference's ``_dot_flops``), 1 x output elements for anything else."""
    out_elems = sum(int(np.prod(m.shape)) for m in outputs)
    k = _contraction(base, args)
    return float(2 * out_elems * k if k is not None else out_elems)


@dataclasses.dataclass
class OpTrace:
    """What ``trace_ops`` saw. ``launches``: (kernel, count, path) of the
    ctypes kernels launched; ``steps``: (round body, in_place) per
    block-executor call; ``in_place_moves``: per in-place round, the
    indices of the state leaves whose storage changed; ``sync_errors``:
    (path, message) of the syncs ``set_sync_debug_mode`` caught;
    ``aux_rows``: each round's aux output (``with_aux`` bodies);
    ``counters``: the telemetry counters of the state each round left
    (None without telemetry)."""

    ops: list = dataclasses.field(default_factory=list)
    launches: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)
    in_place_moves: list = dataclasses.field(default_factory=list)
    sync_errors: list = dataclasses.field(default_factory=list)
    aux_rows: list = dataclasses.field(default_factory=list)
    counters: list = dataclasses.field(default_factory=list)
    devices: set = dataclasses.field(default_factory=set)
    result: Any = None

    def within(self, region: str | None) -> Iterator[OpRecord]:
        """The ops run inside ``region`` (None: every op)."""
        return (op for op in self.ops
                if region is None or region in op.path)

    def launch_counts(self, region: str | None = None) -> dict:
        out: dict = {}
        for name, n, path in self.launches:
            if region is None or region in path:
                out[name] = out.get(name, 0) + n
        return out


def _launch_counters() -> dict:
    from repro_torch.kernels import cd_glm, flash_attention
    return {"cd_glm": cd_glm.LAUNCHES, "flash_attention":
            flash_attention.LAUNCHES}


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: OpTrace):
        super().__init__()
        self.trace = trace
        self.path: list = []
        self._counters = _launch_counters()
        self._seen = self._launch_snapshot()

    def _launch_snapshot(self) -> dict:
        return {name: n for table in self._counters.values()
                for name, n in table.items()}

    def flush_launches(self) -> None:
        now = self._launch_snapshot()
        for name, n in now.items():
            if n != self._seen.get(name, 0):
                self.trace.launches.append((name, n - self._seen.get(name, 0),
                                            tuple(self.path)))
        self._seen = now

    def region(self, name: str, entering: bool) -> None:
        self.flush_launches()
        if entering:
            self.path.append(name)
        elif self.path and self.path[-1] == name:
            self.path.pop()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.flush_launches()
        base = func.overloadpacket.__name__
        ins = tuple(_meta(t) for t in _pytree.tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor))
        outs = tuple(_meta(t) for t in _pytree.tree_leaves(out)
                     if isinstance(t, torch.Tensor))
        self.trace.devices.update(m.device for m in ins + outs)
        view = bool(func.is_view)
        flops = 0.0 if view or base in _NO_WORK else \
            op_flops(base, args, outs)
        self.trace.ops.append(OpRecord(str(func), tuple(self.path), ins,
                                       outs, view, flops))
        return out


def _state_leaves(state) -> list:
    return [t for t in _pytree.tree_leaves(state)
            if isinstance(t, torch.Tensor)]


_SYNC_MARK = "synchroniz"   # set_sync_debug_mode's "...synchronizing..."


def trace_ops(fn: Callable, *args, sync_debug: bool = True,
              **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` and record its ops (see the module).

    ``sync_debug``: arm ``torch.cuda.set_sync_debug_mode("error")`` around
    every round body whose state lives on a CUDA device. A sync it catches
    ends the run: it is recorded in ``sync_errors`` (a ``host-sync-in-block``
    finding) and ``trace_ops`` returns the trace so far; any other error
    propagates."""
    trace = OpTrace()
    rec = _Recorder(trace)

    def wrap(step_fn, in_place=False, with_aux=False):
        trace.steps.append((step_fn, in_place))

        def wrapped(state, *rest):
            leaves = _state_leaves(state)
            before = [t.data_ptr() for t in leaves]
            cuda = sync_debug and any(t.is_cuda for t in leaves)
            prev = torch.cuda.get_sync_debug_mode() if cuda else None
            rec.region("step", True)
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = step_fn(state, *rest)
            except RuntimeError as e:
                if cuda and _SYNC_MARK in str(e):
                    trace.sync_errors.append((tuple(rec.path), str(e)))
                raise
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(prev)
                rec.region("step", False)
            new = out[0] if with_aux else out
            if with_aux:
                trace.aux_rows.append(out[1])
            trace.counters.append(getattr(new, "counters", None))
            if in_place:
                after = [t.data_ptr() for t in _state_leaves(new)]
                trace.in_place_moves.append(
                    [i for i, (a, b) in enumerate(zip(before, after))
                     if a != b] + ([-1] if len(after) != len(before) else []))
            return out

        return wrapped

    try:
        with executor.region_listener(rec.region), \
                executor.step_wrapper(wrap), rec:
            trace.result = fn(*args, **kwargs)
            rec.flush_launches()
    except RuntimeError:
        if not trace.sync_errors:
            raise
    return trace


# -- passes over a trace ----------------------------------------------------

def _inside(path: tuple) -> str:
    return "/".join(path) or "<top>"


@register_pass("dtype-drift")
def dtype_drift(trace: OpTrace, *, compute_dtype=torch.float32,
                wire_dtypes: tuple = (), region: str | None = "block",
                where: str = "") -> List[Finding]:
    """Flag every floating / complex result inside ``region`` whose dtype
    is neither the compute dtype nor one of the declared ``wire_dtypes``:
    a float64 promotion or a silent bf16 / f16 round trip."""
    allowed = {compute_dtype, *wire_dtypes}
    out: List[Finding] = []
    seen: set = set()
    for op in trace.within(region):
        for m in op.outputs:
            if not (m.dtype.is_floating_point or m.dtype.is_complex) \
                    or m.dtype in allowed:
                continue
            key = (op.name, m.dtype, op.path)
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                "dtype-drift",
                f"{op.name} output has dtype {m.dtype} (compute dtype is "
                f"{compute_dtype}) inside {_inside(op.path)}", where))
    return out


# ops whose result the host must wait for
_SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                       "_unique", "_unique2", "unique_dim",
                       "unique_consecutive", "equal"})


def _syncs(op: OpRecord) -> bool:
    base = op.name.split(".")[1]
    if base in _SYNC_OPS:
        return True
    if base in ("index", "index_put", "index_put_"):
        # a boolean mask index is a nonzero inside the op
        return any(m.dtype == torch.bool for m in op.inputs[1:])
    if base == "repeat_interleave" and op.name.endswith(".Tensor"):
        return True
    if base in ("_to_copy", "copy_"):
        # a copy to the host from a device
        srcs = op.inputs[1:] if base == "copy_" else op.inputs
        return (any(m.device.type == "cpu" for m in op.outputs)
                and any(m.device.type != "cpu" for m in srcs))
    return False


@register_pass("host-sync-in-block")
def host_sync_in_block(trace: OpTrace, *, region: str = "round",
                       where: str = "") -> List[Finding]:
    """Flag every op inside a round that reads a device value back on the
    host, and every sync ``set_sync_debug_mode`` caught in a round body:
    one per round defeats the block executor's one sync per block."""
    out: List[Finding] = []
    for op in trace.within(region):
        if _syncs(op):
            out.append(Finding(
                "host-sync-in-block",
                f"{op.name} inside {_inside(op.path)}: a host sync every "
                "round defeats the round-block dispatch amortization",
                where))
    for path, msg in trace.sync_errors:
        out.append(Finding(
            "host-sync-in-block",
            f"set_sync_debug_mode caught a sync inside {_inside(path)}: "
            f"{msg.splitlines()[0]}", where))
    return out


def _captured(obj, name: str, depth: int, seen: set) -> Iterator[tuple]:
    """(name, value) of every array reachable from ``obj`` through
    closures, ``functools.partial`` arguments, bound methods, containers
    and dataclass fields."""
    if depth > 8 or id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        yield name, obj
    elif isinstance(obj, types.FunctionType):
        for var, cell in zip(obj.__code__.co_freevars, obj.__closure__ or ()):
            try:
                val = cell.cell_contents
            except ValueError:  # an empty cell
                continue
            yield from _captured(val, f"{name}.{var}", depth + 1, seen)
    elif isinstance(obj, types.MethodType):
        yield from _captured(obj.__func__, name, depth + 1, seen)
        yield from _captured(obj.__self__, f"{name}.__self__", depth + 1,
                             seen)
    elif isinstance(obj, functools.partial):
        for i, val in enumerate(obj.args):
            yield from _captured(val, f"{name}.args[{i}]", depth + 1, seen)
        for key, val in obj.keywords.items():
            yield from _captured(val, f"{name}.{key}", depth + 1, seen)
        yield from _captured(obj.func, name, depth + 1, seen)
    elif isinstance(obj, (tuple, list)):
        for i, val in enumerate(obj):
            yield from _captured(val, f"{name}[{i}]", depth + 1, seen)
    elif isinstance(obj, dict):
        for key, val in obj.items():
            yield from _captured(val, f"{name}[{key!r}]", depth + 1, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _captured(getattr(obj, f.name), f"{name}.{f.name}",
                                 depth + 1, seen)


@register_pass("constant-capture")
def constant_capture(trace: OpTrace, *, device=None,
                     max_bytes: int = 1 << 20,
                     where: str = "") -> List[Finding]:
    """Flag every host array above ``max_bytes`` a round body closes over:
    a numpy array, or a CPU tensor when the run is on another device
    (``device``; default: the device of the traced ops)."""
    if device is None:
        others = {d for d in trace.devices if d.type != "cpu"}
        device = next(iter(others)) if others else torch.device("cpu")
    device = torch.device(device)
    out: List[Finding] = []
    for step_fn, _ in trace.steps:
        for name, val in _captured(step_fn, "step_fn", 0, set()):
            host = isinstance(val, np.ndarray) or (
                val.device.type == "cpu" and device.type != "cpu")
            nbytes = (val.nbytes if isinstance(val, np.ndarray)
                      else val.numel() * val.element_size())
            if host and nbytes > max_bytes:
                out.append(Finding(
                    "constant-capture",
                    f"round body captures host array {name} "
                    f"{val.dtype}{list(val.shape)} of {nbytes:,} bytes (> "
                    f"{max_bytes:,}): it crosses to {device} every round — "
                    "put it in the executor's schedule or context", where))
    return out


@register_pass("in-place")
def in_place(trace: OpTrace, *, where: str = "") -> List[Finding]:
    """Every in-place round body kept each state leaf's storage."""
    if not any(ip for _, ip in trace.steps):
        return [Finding("in-place", "no in-place round body ran", where)]
    out: List[Finding] = []
    for i, moved in enumerate(trace.in_place_moves):
        if moved:
            what = ("the state's leaves changed in number" if -1 in moved
                    else f"state leaves {moved} got new storage")
            out.append(Finding(
                "in-place",
                f"round {i}: {what}: the in-place body silently "
                "double-buffers the state", where))
    return out


# -- retrace detection ------------------------------------------------------

class RetraceMonitor:
    """Record, in a scope, the executor's cache events, its
    ``run_round_blocks`` calls and the kernel builds and library loads.

    >>> with RetraceMonitor() as mon:
    ...     run()
    >>> mon.events, mon.runs, mon.builds
    """

    def __init__(self):
        self.events: list = []
        self.runs = 0
        self.builds: dict = {}
        self._cms: list = []

    def _count(self, step_fn, **_):
        self.runs += 1
        return step_fn

    def __enter__(self):
        from repro_torch.kernels import build
        self._counts0 = dict(build.BUILD_COUNTS)
        self._loaded0 = set(build._LOADED)
        self._cms = [executor.cache_listener(self._on),
                     executor.step_wrapper(self._count)]
        for cm in self._cms:
            cm.__enter__()
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import build
        for cm in reversed(self._cms):
            cm.__exit__(*exc)
        self._cms = []
        self.builds = {k: build.BUILD_COUNTS[k] - self._counts0[k]
                       for k in self._counts0}
        self.builds["new_libraries"] = sorted(set(build._LOADED)
                                              - self._loaded0)
        return False

    def _on(self, key, kind: str) -> None:
        self.events.append((key, kind))

    @property
    def misses(self) -> list:
        """Every event but the one bypass a block-executor call reports."""
        return [e for e in self.events if e[1] != "bypass"]


def retrace_findings(mon: RetraceMonitor, where: str = "") -> List[Finding]:
    out: List[Finding] = []
    for key, kind in mon.misses:
        out.append(Finding(
            "retrace",
            f"cache {kind} on warmed key {key!r}: the port caches no driver, "
            "so a warmed run reports one bypass per block-executor call "
            "and nothing else — an unstable key", where))
    bypasses = sum(kind == "bypass" for _, kind in mon.events)
    if bypasses != mon.runs:
        out.append(Finding(
            "retrace",
            f"{bypasses} bypass event(s) for {mon.runs} block-executor "
            "call(s): want exactly one each", where))
    built = {k: v for k, v in mon.builds.items() if v}
    if built:
        out.append(Finding(
            "retrace",
            f"the warmed run built or loaded kernels: {built}", where))
    return out


@register_pass("retrace")
def check_retrace(run_fn: Callable, *, warmups: int = 1,
                  where: str = "") -> List[Finding]:
    """Run ``run_fn`` ``warmups`` times, then once more under a
    ``RetraceMonitor``: any event but one bypass per block-executor call,
    or a kernel build or load on the warmed run, is a finding."""
    for _ in range(warmups):
        run_fn()
    with RetraceMonitor() as mon:
        run_fn()
    return retrace_findings(mon, where)


def _aux_entries(aux) -> list:
    if aux is None:
        return []
    return list(aux.values()) if isinstance(aux, dict) else [aux]


@register_pass("telemetry-carry")
def telemetry_carry(off: OpTrace, on: OpTrace, *,
                    where: str = "") -> List[Finding]:
    """Hold a telemetry-on run's trace to its off twin's: its rounds return
    more aux entries, each a device tensor, and carry device counters in
    the state that advance every round. A counter taken as a Python number
    or a host constant before the block never advances (the reference's
    "the counters ride the round scan's carry")."""
    out: List[Finding] = []
    most = lambda tr: max((len(_aux_entries(a)) for a in tr.aux_rows),
                          default=0)
    if most(on) <= most(off):
        out.append(Finding(
            "telemetry-carry",
            f"telemetry-on rounds return {most(on)} aux entries, no more "
            f"than the telemetry-off twin's {most(off)}: the counters are "
            "not written per round", where))
    counters = [c for c in on.counters if c is not None]
    leaves = [t for c in counters for t in _state_leaves(c)]
    if not counters or len(counters) != len(on.counters) or any(
            not isinstance(t, torch.Tensor) for c in counters for t in c):
        out.append(Finding(
            "telemetry-carry",
            "the rounds leave no device counters in the carried state",
            where))
        return out
    devices = {t.device for t in leaves}
    for row in on.aux_rows:
        for val in _aux_entries(row):
            if not isinstance(val, torch.Tensor) or val.device not in devices:
                out.append(Finding(
                    "telemetry-carry",
                    f"a round's aux entry is {type(val).__name__}, not a "
                    "tensor on the counters' device "
                    f"{sorted(map(str, devices))}", where))
                return out
    ticks = [int(c.rounds) for c in counters]
    if any(b - a != 1 for a, b in zip([ticks[0] - 1] + ticks, ticks)):
        out.append(Finding(
            "telemetry-carry",
            f"the carried round counter reads {ticks} over {len(ticks)} "
            "rounds: the counters are constants taken before the block, "
            "not carried", where))
    return out


# -- one block program ------------------------------------------------------

@dataclasses.dataclass
class BlockProgram:
    """One block of a round body on the executor: ``run_round_blocks(
    step_fn, state, schedule, context=, num_rounds=, block_size=num_rounds,
    in_place=, with_aux=, host_entries=)``."""

    step_fn: Callable
    state: Any
    schedule: dict
    num_rounds: int
    context: Any = None
    in_place: bool = False
    with_aux: bool = False
    host_entries: tuple = ()

    def run(self):
        return executor.run_round_blocks(
            self.step_fn, self.state, self.schedule, context=self.context,
            num_rounds=self.num_rounds, block_size=self.num_rounds,
            in_place=self.in_place, with_aux=self.with_aux,
            host_entries=self.host_entries)


def trace_passes(trace: OpTrace, *, in_place_body: bool = False,
                 compute_dtype=torch.float32, wire_dtypes: tuple = (),
                 max_const_bytes: int = 1 << 20,
                 where: str = "") -> List[Finding]:
    """dtype-drift, host-sync-in-block, constant-capture (and in-place for
    an in-place body) over a trace of block-executor runs."""
    out: List[Finding] = []
    if not trace.steps:
        out.append(Finding("trace", "no block-executor call ran", where))
    out += dtype_drift(trace, compute_dtype=compute_dtype,
                       wire_dtypes=wire_dtypes, where=where)
    out += host_sync_in_block(trace, where=where)
    out += constant_capture(trace, max_bytes=max_const_bytes, where=where)
    if in_place_body:
        out += in_place(trace, where=where)
    return out


def run_block_passes(program: BlockProgram, *, warm: bool = True,
                     where: str = "", **kw) -> List[Finding]:
    """All trace passes over one block of ``program`` (warmed once first:
    kernels built and libraries loaded before the traced block)."""
    if warm:
        program.run()
    trace = trace_ops(program.run)
    return trace_passes(trace, in_place_body=program.in_place, where=where,
                        **kw)
