"""Carry data and state across from numpy, so a run can start from the same
inputs as another implementation (e.g. the JAX reference) and hand its
results back (a quantized wire's EF residual and pipelined payload
included). Precomputed certificate constants need no conversion:
``metrics.certificate_recorder(sigma_k=)`` takes the (K,) sigma_k as any
array.

``consensus_problem_from_numpy`` carries the reference's row-partitioned
``ConsensusProblem`` (its arrays as numpy) across for the baselines.

For the model zoo: ``model_params_from_numpy`` takes the reference's
parameter pytree as numpy arrays (layer-stacked, as ``_stack_init`` builds
it; a MoE group's dense layers and a hybrid group's Mamba2 blocks as
lists; the hybrid's unstacked ``shared`` block; encdec's encoder stacked
over its own depth, ``enc_layers``, beside ``enc_in_proj`` and
``enc_ln_f``; vlm's ``patch_proj``) into the port's one flat
dict (``transformer.param_paths``, shapes from ``transformer.param_leaves``),
``load_checkpoint`` reads an npz written by the reference's
``train.checkpoint.save`` (leaves keyed by ``jax.tree_util.keystr`` paths,
parsed here as strings), and ``cache_to_numpy`` hands a decode cache back.
``train_state_from_numpy`` / ``train_state_to_numpy`` carry a training
state (fp32 masters, the optimizer's moments, the step) across in the
reference's layout, single or with a leading (K,) replica axis (gossip).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.core.baselines import ConsensusProblem
from repro_torch.core import quant
from repro_torch.core.cola import ColaState
from repro_torch.core.problems import PROBLEMS, Problem
from repro_torch.device import resolve
from repro_torch.models import transformer
from repro_torch.models.common import nest
from repro_torch.train.steps import TrainState


def problem_from_numpy(name: str, x, y, lam: float, *, device,
                       **kw) -> Problem:
    """``PROBLEMS[name]`` built from numpy data on ``device`` — the same
    arguments ``repro.core.problems.PROBLEMS[name]`` takes."""
    return PROBLEMS[name](np.asarray(x), np.asarray(y), lam, device=device,
                          **kw)


def state_from_numpy(x_parts, v_stack, *, device, ef=None, buf=None,
                     wire: str | None = None) -> ColaState:
    """A ``ColaState`` from (K, n_k) / (K, d) arrays, and on a quantized
    wire the (K, d) EF residual ``ef`` and the pipelined payload ``buf`` =
    (payload bits, (K, 1) fp32 scale): the payload as int8 or fp8 bits
    (any 1-byte numpy dtype, e.g. the reference's float8 arrays viewed as
    uint8), read as ``wire``'s dtype."""
    dev = resolve(device)
    # copies: a run may update its state in place (the cohort round does),
    # which must not write through to the caller's arrays
    as_t = lambda a: torch.tensor(np.asarray(a), device=dev)
    if buf is not None:
        if not quant.is_quantized(wire):
            raise ValueError("buf= needs the quantized wire it was encoded "
                             f"for, got wire={wire!r}")
        bits, scale = buf
        bits = np.asarray(bits).view(np.uint8)
        buf = (as_t(bits).view(quant.wire_dtype(wire)),
               as_t(scale))
    return ColaState(x_parts=as_t(x_parts), v_stack=as_t(v_stack),
                     ef=None if ef is None else as_t(ef), buf=buf)


def state_to_numpy(state: ColaState) -> tuple:
    """(x_parts, v_stack) as numpy arrays; a state with a quantized wire's
    ``ef`` or ``buf`` gives (x_parts, v_stack, ef, buf), ``buf`` as
    (payload bits as uint8, scale) or None."""
    x, v = state.x_parts.cpu().numpy(), state.v_stack.cpu().numpy()
    if state.ef is None and state.buf is None:
        return x, v
    ef = None if state.ef is None else state.ef.cpu().numpy()
    buf = None
    if state.buf is not None:
        q, scale = state.buf
        buf = (q.view(torch.uint8).cpu().numpy(), scale.cpu().numpy())
    return x, v, ef, buf


def consensus_problem_from_numpy(x_parts, y_parts, row_mask, *, loss: str,
                                 reg: str, lam: float,
                                 device) -> ConsensusProblem:
    """A baselines ``ConsensusProblem`` from the (K, m_k, d) / (K, m_k) /
    (K, m_k) row blocks of another implementation's, e.g. the reference's
    ``ConsensusProblem`` fields as numpy."""
    dev = resolve(device)
    return ConsensusProblem(
        *(torch.tensor(np.asarray(a), device=dev)
          for a in (x_parts, y_parts, row_mask)), loss=loss, reg=reg,
        lam=float(lam))


def _tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _tree_leaves(sub, prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _tree_leaves(sub, prefix + (i,))
    else:
        yield prefix, tree


def _leaves_from_numpy(cfg, tree, *, replicas: bool = False):
    """(name, array) in ``transformer.param_paths`` order from the
    reference's parameter tree (a list of layers, as ``layers.dense``, or
    a dict with int keys, as ``load_checkpoint`` builds it). The shapes
    come from ``transformer.param_leaves``; with ``replicas`` a leading
    (K,) axis is allowed. A missing, extra or misshapen leaf raises."""
    flat = _nested_to_flat(tree)
    want = transformer.param_leaves(cfg)
    missing = [name for name in want if name not in flat]
    if missing:
        raise KeyError(f"parameter tree has no leaf {missing}")
    extra = sorted(set(flat) - set(want))
    if extra:
        raise ValueError(f"parameter tree has leaves the model lacks: {extra}")
    for name, leaf in want.items():
        arr = np.asarray(flat[name])
        lead = arr.ndim - len(leaf.shape)
        if tuple(arr.shape[max(lead, 0):]) != leaf.shape \
                or lead not in ((0, 1) if replicas else (0,)):
            raise ValueError(f"{name}: shape {arr.shape} != {leaf.shape}"
                             + (" nor (K,) + it" if replicas else ""))
        yield name, arr


def model_params_from_numpy(cfg, tree, *, device) -> dict:
    """The port's serving parameters (``transformer.param_paths``, in
    ``cfg.dtype``) from the reference's parameter pytree as numpy
    (``jax.tree.map(np.asarray, params)``): the layer leaves carry a
    leading (groups,) axis, encdec's ``enc_layers`` leaves a leading
    (encoder_layers,) axis. A missing, extra or misshapen leaf raises."""
    dev = resolve(device)
    dtype = getattr(torch, cfg.dtype)
    return {name: torch.from_numpy(np.array(arr, dtype=np.float32))
            .to(dtype).to(dev)
            for name, arr in _leaves_from_numpy(cfg, tree)}


_KEYSTR = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]")


def parse_keystr(key: str) -> tuple:
    """``"['layers']['attn']['wq']"`` -> ("layers", "attn", "wq"); a list
    index ``[0]`` becomes the int 0."""
    path, pos = [], 0
    for m in _KEYSTR.finditer(key):
        if m.start() != pos:
            break
        path.append(m.group(1) if m.group(2) is None else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not path:
        raise ValueError(f"not a keystr path: {key!r}")
    return tuple(path)


def load_checkpoint(path: str) -> dict:
    """The nested dict of numpy arrays in an npz written by the reference's
    ``train.checkpoint.save``."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            keys = parse_keystr(key)
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = data[key]
    return tree


def cache_to_numpy(cache):
    """A decode cache as numpy in the reference's layout: a KV cache (k, v
    as float32 — numpy has no bf16 — and pos as int32), or a recurrent
    family's nested tree of states (lists stay lists)."""
    if isinstance(cache, dict):
        return {key: cache_to_numpy(t) for key, t in cache.items()}
    if isinstance(cache, list):
        return [cache_to_numpy(t) for t in cache]
    return (cache.float() if cache.is_floating_point() else cache
            ).cpu().numpy()


def _nested_to_flat(tree, prefix=()) -> dict:
    """A nested dict of arrays -> {dotted name: array}."""
    return {".".join(map(str, path)): leaf
            for path, leaf in _tree_leaves(tree, prefix)}


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def params_from_numpy(cfg, tree, *, device, dtype=torch.float32) -> dict:
    """The training layout (``transformer.param_paths``) from the
    reference's parameter tree as numpy, each leaf copied to ``device`` in
    ``dtype``; a leading replica axis (K, ...) is kept. A missing, extra
    or misshapen leaf raises."""
    dev = resolve(device)
    return {name: torch.tensor(np.asarray(arr, np.float32),
                               device=dev).to(dtype)
            for name, arr in _leaves_from_numpy(cfg, tree, replicas=True)}


def train_state_from_numpy(cfg, tree, *, device) -> TrainState:
    """A ``TrainState`` from the reference's (``jax.tree.map(np.asarray,
    state)``, or a dict with ``params``, ``opt_state`` and ``step``):
    masters in ``cfg.param_dtype``, each moment in its stored dtype (fp32
    or bf16, as numpy holds it), the step as int32."""
    dev = resolve(device)
    params = params_from_numpy(cfg, _field(tree, "params"), device=dev,
                               dtype=getattr(torch, cfg.param_dtype))
    opt_state = {}
    for key, sub in _field(tree, "opt_state").items():
        dtypes = {name: np.asarray(a).dtype
                  for name, a in _nested_to_flat(sub).items()}
        moments = params_from_numpy(cfg, sub, device=dev)
        opt_state[key] = {
            name: (t.to(torch.bfloat16) if dtypes[name].name == "bfloat16"
                   else t) for name, t in moments.items()}
    step = torch.tensor(np.asarray(_field(tree, "step")), dtype=torch.int32,
                        device=dev)
    return TrainState(params=params, opt_state=opt_state, step=step)


def train_state_to_numpy(state: TrainState) -> dict:
    """{"params", "opt_state", "step"} as nested dicts of numpy arrays in
    the reference's layout (bf16 moments as fp32: numpy has no bf16)."""
    arr = lambda t: (t.float() if t.dtype == torch.bfloat16 else t
                     ).detach().cpu().numpy()
    nested = lambda flat: nest({n: arr(t) for n, t in flat.items()})
    return {"params": nested(state.params),
            "opt_state": {key: nested(sub)
                          for key, sub in state.opt_state.items()},
            "step": state.step.cpu().numpy()}
