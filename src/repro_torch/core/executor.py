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
* a recorder with a stop condition (``stop_fn``) arms early exit through a
  device-side stop flag. Once a recorded row satisfies it, the remaining
  rounds of the block become no-ops (the state is carried through
  unchanged by a ``torch.where`` select, so the stopped run's final state
  equals the full run's state at the stop round), and the host reads the
  flag once per block and skips the blocks after it.

PyTorch runs eagerly, so a no-op round still computes its round body before
the select discards it, and the reference's compiled-driver cache has no
counterpart here. Capturing a block as a CUDA graph is later work.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class BlockRunResult(NamedTuple):
    state: Any
    metrics: np.ndarray | None  # (R, m) rows of the recorded rounds
    # (R,) round indices of the metric rows — truncated at the stop round
    rounds: np.ndarray | None = None
    stop_round: int | None = None  # round that stopped the run, or None


def _leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
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
                     host_entries: tuple = ()) -> BlockRunResult:
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

    Returns:
      BlockRunResult(state, metrics, rounds, stop_round).
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

    row_i = 0
    executed = 0
    stopped_early = False
    start = 0
    while start < t_total:
        stop = min(start + block_size, t_total)
        sched_b = {name: (np.asarray(v[start:stop]) if name in host_entries
                          else torch.as_tensor(
                              np.ascontiguousarray(v[start:stop]),
                              device=device))
                   for name, v in schedule.items()}
        for t in range(start, stop):
            sched_t = {name: v[t - start] for name, v in sched_b.items()}
            new_state = step_fn(state, context, sched_t)
            state = (_select(stopped, state, new_state) if has_stop
                     else new_state)
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
                metrics[t] = torch.where(do_rec, row, torch.zeros_like(row))
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
        # the host-side short-circuit: one scalar sync per block, only when
        # early exit is armed
        if has_stop and bool(stopped):
            stopped_early = True
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
                          stop_round=stop_round)


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
