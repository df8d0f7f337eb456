"""Round-block execution engine: many rounds per host synchronisation.

A per-round driver that fetches every metric row and checks its stop
condition on the host waits for the device every round. This engine keeps
the device busy instead:

* rounds run in blocks of ``block_size``; the host enqueues a whole block
  without waiting for the device;
* each record round writes its metric row into a preallocated device
  tensor; the rows are fetched once, at the end of the run;
* schedule entries (``(T, ...)`` host arrays) are moved to the device once
  per block; entries named in ``host_entries`` stay on the host, so a round
  body can branch on them in Python without a device sync (the COLA driver
  gates the leaver reset on its host ``reset_any`` flag this way);
* a ``stream`` generator ``t -> {entry: tensor}`` is evaluated on the
  device for each round and merged over the round's schedule slice, so
  per-round inputs that are cheap to re-derive (participation masks,
  sampled mixing matrices) need no (T, ...) schedule;
* a recorder with a stop condition (``stop_fn``) arms early exit through a
  device-side stop flag. Once a recorded row satisfies it, the remaining
  rounds of the block become no-ops (the state is carried through
  unchanged by a ``torch.where`` select, so the stopped run's final state
  equals the full run's state at the stop round), and the host reads the
  flag once per block and skips the blocks after it. An ``in_place`` round
  body updates the state itself and gets the stop flag to keep it
  unchanged: the cohort round writes K' rows of a (K, d) state, where a
  select over the whole state would copy all of it every round.
* a step may also return a per-round output (``with_aux``: a tensor or a
  dict of tensors, such as the eavesdropper's taps and the telemetry
  counters' rows), which the engine writes into preallocated ``(T, ...)``
  device tensors, zeros for the rounds after the stop;
* each block runs inside a ``repro_torch.obs.trace`` span
  (``block-first-dispatch``, then ``block-dispatch``, with ``start=`` and
  ``rounds=``) on the active tracer. The span times the host: the block's
  enqueue, plus its read of the stop flag when a stop is armed.

PyTorch runs eagerly, so a no-op round still computes its round body before
the select discards it, and the reference's compiled-driver cache has no
counterpart here: every ``run_round_blocks`` call reports one ``"bypass"``
event to the ``cache_listener``s, the reference's event for a build
without a cache. Capturing a block as a CUDA graph is later work.

Two more hooks serve the contract analysis (``repro_torch.analysis``),
and cost nothing while none is registered: a ``region_listener`` hears
each block and each round begin and end (``("block" | "round",
entering)``; a round spans its body, its record and its stop update, and
the block's stop-flag read lies outside every round), the eager form of
the reference's scan / while regions; a ``step_wrapper`` replaces the
round body each call runs with ``wrap(step_fn, in_place=, with_aux=)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import types
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

# Cache-event listeners (``cache_listener``): the reference's executor
# reports each compiled-driver resolution; the port has no driver cache and
# reports one "bypass" per run_round_blocks call.
_CACHE_LISTENERS: list = []


def _cache_event(key, kind: str) -> None:
    for listener in list(_CACHE_LISTENERS):
        listener(key, kind)


@contextlib.contextmanager
def _registered(registry: list, fn):
    registry.append(fn)
    try:
        yield fn
    finally:
        try:
            registry.remove(fn)
        except ValueError:  # already removed (a test cleared the list)
            pass


def cache_listener(fn: Callable[[Any, str], None]):
    """Register ``fn(key, kind)`` for cache events, removably.

    The listener is appended on entry and removed on exit even if the body
    raises, so nested monitors (``obs.trace`` tracers) never double-count
    or leak a stale callback across tests. The same function object may be
    registered by nested scopes — each exit removes exactly one
    registration."""
    return _registered(_CACHE_LISTENERS, fn)


# Region listeners and step wrappers (module docstring).
_REGION_LISTENERS: list = []
_STEP_WRAPPERS: list = []


def region_listener(fn: Callable[[str, bool], None]):
    """Register ``fn(region, entering)`` for the block and round regions of
    every ``run_round_blocks`` call in the scope (removed on exit)."""
    return _registered(_REGION_LISTENERS, fn)


def step_wrapper(wrap: Callable[..., Callable]):
    """Register ``wrap(step_fn, in_place=, with_aux=) -> step_fn``: every
    ``run_round_blocks`` call in the scope runs the wrapped round body."""
    return _registered(_STEP_WRAPPERS, wrap)


@contextlib.contextmanager
def _region(listeners: list, name: str):
    for fn in listeners:
        fn(name, True)
    try:
        yield
    finally:
        for fn in listeners:
            fn(name, False)


def _fp_update(h, obj, seen: set) -> None:
    """Feed ``obj``'s content (not its address) into the hash ``h``:
    tensors and arrays by shape, dtype and bytes; functions by bytecode,
    closure cells, defaults and the names of the globals they read;
    dataclasses by their fields. ``seen`` guards cycles."""
    if isinstance(obj, (types.FunctionType, dict)) or (
            dataclasses.is_dataclass(obj) and not isinstance(obj, type)):
        if id(obj) in seen:
            h.update(b"<cycle>")
            return
        seen.add(id(obj))
    h.update(type(obj).__name__.encode())
    if obj is None or isinstance(obj, (bool, int, float, complex, str,
                                       bytes, np.generic)):
        h.update(repr(obj).encode())
    elif isinstance(obj, torch.Tensor):
        t = obj.detach().contiguous().cpu()
        h.update(f"{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    elif isinstance(obj, np.ndarray):
        h.update(f"{obj.shape}{obj.dtype}".encode())
        h.update(np.ascontiguousarray(obj).reshape(-1).view(np.uint8))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _fp_update(h, x, seen)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            _fp_update(h, k, seen)
            _fp_update(h, obj[k], seen)
    elif isinstance(obj, functools.partial):
        _fp_update(h, (obj.func, obj.args, dict(obj.keywords)), seen)
    elif isinstance(obj, types.FunctionType):
        _fp_update(h, obj.__code__, seen)
        for cell in obj.__closure__ or ():
            try:
                _fp_update(h, cell.cell_contents, seen)
            except ValueError:  # empty cell
                h.update(b"<empty-cell>")
        _fp_update(h, (obj.__defaults__, obj.__kwdefaults__), seen)
        h.update(" ".join(n for n in sorted(obj.__code__.co_names)
                          if n in obj.__globals__).encode())
    elif isinstance(obj, types.CodeType):
        h.update(obj.co_code)
        h.update(" ".join(obj.co_names).encode())
        for c in obj.co_consts:
            _fp_update(h, c, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            _fp_update(h, getattr(obj, f.name), seen)
    else:
        h.update(repr(obj).encode())


_FP_MEMO_ATTR = "_fingerprint_memo"


def fingerprint(*objs: Any) -> str:
    """Content digest of ``objs`` (a RunReport's ``problem`` field): two
    separately built objects with the same contents get the same digest,
    objects that differ in any tensor, closure constant or hyperparameter
    get different ones.

    Hashing a Problem copies its (d, n) data matrix to the host and hashes
    it (3.2 GB at the epsilon shape), so a single frozen-dataclass argument
    memoizes its digest on the instance, as the reference does: repeated
    runs over one Problem hash it once. (Sound because a frozen Problem is
    never written in place by the port.)"""
    memoizable = (len(objs) == 1 and dataclasses.is_dataclass(objs[0])
                  and not isinstance(objs[0], type)
                  and type(objs[0]).__dataclass_params__.frozen)
    if memoizable:
        memo = getattr(objs[0], _FP_MEMO_ATTR, None)
        if memo is not None:
            return memo
    h = hashlib.sha256()
    seen: set = set()
    for o in objs:
        _fp_update(h, o, seen)
    digest = h.hexdigest()
    if memoizable:
        object.__setattr__(objs[0], _FP_MEMO_ATTR, digest)
    return digest


class BlockRunResult(NamedTuple):
    state: Any
    metrics: np.ndarray | None  # (R, m) rows of the recorded rounds
    # (R,) round indices of the metric rows — truncated at the stop round
    rounds: np.ndarray | None = None
    stop_round: int | None = None  # round that stopped the run, or None
    # (executed rounds, ...) per-round step outputs on the device
    # (``with_aux``), zeros after the stop round; or None
    aux: Any = None


def _leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        state = state.values()
    return [x for s in state for x in _leaves(s)] if state is not None else []


def _select(keep_old, old, new):
    """``torch.where(keep_old, old, new)`` over a tensor or a (named) tuple
    of tensors (None leaves pass through)."""
    if old is None:
        return new
    if isinstance(old, torch.Tensor):
        return torch.where(keep_old, old, new)
    parts = [_select(keep_old, o, n) for o, n in zip(old, new)]
    return type(old)(*parts) if hasattr(old, "_fields") else type(old)(parts)


def _num_rounds(schedule, record_mask, num_rounds) -> int:
    if num_rounds is not None:
        return int(num_rounds)
    if record_mask is not None:
        return int(np.shape(record_mask)[0])
    if schedule:
        return int(np.shape(next(iter(schedule.values())))[0])
    raise ValueError("cannot infer the round count: pass num_rounds, a "
                     "record_mask, or a schedule with (T, ...) entries")


def run_round_blocks(step_fn: Callable[[Any, Any, dict], Any],
                     state: Any, schedule: dict | None, *,
                     context: Any = None,
                     recorder: Any = None,
                     record_mask: np.ndarray | None = None,
                     block_size: int = 64,
                     num_rounds: int | None = None,
                     cadence: Any = None,
                     host_entries: tuple = (),
                     stream: Callable[[int], dict] | None = None,
                     in_place: bool = False,
                     with_aux: bool = False) -> BlockRunResult:
    """Run ``T`` rounds of ``step_fn`` with one host sync per block.

    Args:
      step_fn: ``(state, context, sched_t) -> state`` — the round body.
        ``sched_t`` maps each schedule entry to this round's slice.
      state: carried state, a tensor or a (named) tuple of tensors.
      schedule: dict of ``(T, ...)`` arrays (host numpy is fine — each
        block's slice is moved to the state's device once), or None.
      context: run-constant object passed through to ``step_fn``.
      recorder: a ``repro_torch.core.metrics`` Recorder — ``record_fn`` runs
        on rounds where ``record_mask`` is set, as ``record_fn(state,
        sched_t)`` when ``recorder.uses_schedule`` is set; ``stop_fn``
        (when not None) arms early exit: the round whose row satisfies it
        is the LAST live round.
      record_mask: ``(T,)`` bool — which rounds record a row (default all).
      block_size: rounds per host synchronisation.
      num_rounds: explicit T when neither schedule nor record_mask has it.
      cadence: a ``metrics.AdaptiveCadence`` — replaces ``record_mask``
        with the on-device controller. Every round then evaluates the row
        and the controller keeps it only when due (eager PyTorch cannot
        skip the evaluation without a host sync); the last round always
        records.
      host_entries: names of schedule entries that stay host numpy: their
        ``sched_t`` slice is the numpy value of the round, never a tensor,
        so ``step_fn`` may branch on it without a host sync.
      stream: optional generator ``t -> {entry: tensor}`` (e.g.
        ``schedule.ScheduleProgram.stream_fn``), evaluated for each round
        and merged over its schedule slice (streamed entries win) before
        the step function and the recorder see it.
      in_place: ``step_fn(state, context, sched_t, stopped)`` updates the
        state in place and returns it (with its aux under ``with_aux``);
        ``stopped`` is the 0-d bool stop flag (None when no stop is
        armed), and the step must leave the state unchanged where it is
        set. The engine then selects nothing.
      with_aux: ``step_fn`` returns ``(state, aux)``; each round's ``aux``
        (a tensor, or a dict of tensors; zeros once the stop flag is set,
        as the reference's skipped rounds give) lands in
        ``BlockRunResult.aux``, one row per executed round.

    Returns:
      BlockRunResult(state, metrics, rounds, stop_round, aux).
    """
    schedule = schedule or {}
    t_total = _num_rounds(schedule, record_mask, num_rounds)
    device = _leaves(state)[0].device
    record_fn = recorder.record_fn if recorder is not None else None
    stop_fn = recorder.stop_fn if recorder is not None else None
    # schedule-aware recorders (the churn certificate) also get the round's
    # schedule slice
    if getattr(recorder, "uses_schedule", False):
        record_at = record_fn
    elif record_fn is not None:
        record_at = lambda s, _sched_t: record_fn(s)
    has_stop = stop_fn is not None
    has_cadence = cadence is not None and record_fn is not None
    if record_fn is not None and record_mask is None and not has_cadence:
        record_mask = np.ones((t_total,), dtype=bool)
    rec_all = (np.asarray(record_mask, dtype=bool)
               if record_fn is not None and not has_cadence
               else np.zeros((t_total,), dtype=bool))
    rec_rounds = (np.arange(t_total) if has_cadence
                  else np.nonzero(rec_all)[0])

    n_cols = len(recorder.labels) if recorder is not None else 0
    metrics = torch.zeros((len(rec_rounds), n_cols), dtype=torch.float32,
                          device=device)
    valid = torch.zeros((len(rec_rounds),), dtype=torch.bool, device=device)
    stopped = torch.zeros((), dtype=torch.bool, device=device)
    if has_cadence:
        nxt = torch.zeros((), dtype=torch.int64, device=device)
        every = torch.full((), cadence.base, dtype=torch.int64, device=device)

    aux_buf = None
    row_i = 0
    executed = 0
    stopped_early = False
    start = 0
    # phase tracing (repro_torch.obs.trace; imported here: it imports this
    # module): the active tracer records every block's dispatch
    from repro_torch.obs import trace as obs_trace
    tracer = obs_trace.current()
    _cache_event(None, "bypass")
    for wrap in list(_STEP_WRAPPERS):
        step_fn = wrap(step_fn, in_place=in_place, with_aux=with_aux)
    listeners = list(_REGION_LISTENERS)
    no_region = contextlib.nullcontext()
    region = ((lambda name: _region(listeners, name)) if listeners
              else (lambda name: no_region))
    while start < t_total:
        stop = min(start + block_size, t_total)
        with tracer.span("block-first-dispatch" if start == 0
                         else "block-dispatch", start=start,
                         rounds=stop - start), region("block"):
            sched_b = {name: (np.asarray(v[start:stop])
                              if name in host_entries
                              else torch.as_tensor(
                                  np.ascontiguousarray(v[start:stop]),
                                  device=device))
                       for name, v in schedule.items()}
            for t in range(start, stop):
                with region("round"):
                    sched_t = {name: v[t - start]
                               for name, v in sched_b.items()}
                    if stream is not None:
                        sched_t.update(stream(t))
                    if in_place:
                        new_state = step_fn(state, context, sched_t,
                                            stopped if has_stop else None)
                    else:
                        new_state = step_fn(state, context, sched_t)
                    if with_aux:
                        new_state, aux = new_state
                        aux_buf = _store_aux(aux_buf, aux, t, t_total,
                                             stopped if has_stop else None)
                    state = (new_state if in_place or not has_stop
                             else _select(stopped, state, new_state))
                    if has_cadence:
                        row = record_at(state, sched_t).to(torch.float32)
                        due = (nxt <= t) | (t == t_total - 1)
                        do_rec = due & ~stopped
                        far = recorder.cadence_ratio(row).to(torch.float32) \
                            > cadence.near
                        new_every = torch.where(
                            far, torch.clamp(every * cadence.grow,
                                             max=cadence.max_every),
                            torch.full_like(every, cadence.base))
                        every = torch.where(do_rec, new_every, every)
                        nxt = torch.where(do_rec, t + new_every, nxt)
                        metrics[t] = torch.where(do_rec, row,
                                                 torch.zeros_like(row))
                        valid[t] = do_rec
                        if has_stop:
                            stopped = stopped | (do_rec & stop_fn(row))
                    elif rec_all[t]:
                        row = record_at(state, sched_t).to(torch.float32)
                        metrics[row_i] = row
                        valid[row_i] = ~stopped
                        if has_stop:
                            stopped = stopped | (~stopped & stop_fn(row))
                        row_i += 1
            executed = stop
            start = stop
            # the host-side short-circuit: one scalar sync per block, only
            # when early exit is armed
            stopped_early = has_stop and bool(stopped)
        if stopped_early:
            break

    metrics_np = rounds = None
    stop_round = None
    if record_fn is not None:
        n_rows = executed if has_cadence else row_i
        keep = valid[:n_rows].cpu().numpy()
        metrics_np = metrics[:n_rows].cpu().numpy()[keep]
        rounds = rec_rounds[:n_rows][keep]
        if stopped_early and rounds.size:
            stop_round = int(rounds[-1])
    return BlockRunResult(state=state, metrics=metrics_np, rounds=rounds,
                          stop_round=stop_round,
                          aux=_trim_aux(aux_buf, executed))


def _store_aux(buf, aux, t: int, t_total: int, stopped):
    """Write round ``t``'s aux (a tensor or a dict of tensors) into the
    (T, ...) buffers, allocated at the first round; zeros once ``stopped``
    (None: no stop armed) is set."""
    if isinstance(aux, dict):
        buf = {} if buf is None else buf
        for name, val in aux.items():
            buf[name] = _store_aux(buf.get(name), val, t, t_total, stopped)
        return buf
    if buf is None:
        buf = torch.zeros((t_total,) + tuple(aux.shape), dtype=aux.dtype,
                          device=aux.device)
    buf[t] = aux if stopped is None else torch.where(stopped, 0, aux)
    return buf


def _trim_aux(buf, executed: int):
    if isinstance(buf, dict):
        return {name: v[:executed] for name, v in buf.items()}
    return None if buf is None else buf[:executed]


def make_block_runner(step_fn: Callable, *, recorder: Any = None,
                      block_size: int = 64) -> Callable:
    """Bind a round body and a Recorder into a reusable block runner:
    ``run(state, schedule, *, context=None, record_mask=None,
    num_rounds=None) -> BlockRunResult``."""
    def run(state, schedule, *, context=None, record_mask=None,
            num_rounds=None):
        return run_round_blocks(
            step_fn, state, schedule, context=context, recorder=recorder,
            record_mask=record_mask, block_size=block_size,
            num_rounds=num_rounds)

    return run


def record_flags(rounds: int, record_every: int) -> np.ndarray:
    """The driver-loop recording pattern: every ``record_every``-th round and
    always the last one."""
    t = np.arange(rounds)
    return (t % record_every == 0) | (t == rounds - 1)
