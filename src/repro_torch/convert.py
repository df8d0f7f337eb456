"""Carry data and state across from numpy, so a run can start from the same
inputs as another implementation (e.g. the JAX reference) and hand its
results back. Precomputed certificate constants need no conversion:
``metrics.certificate_recorder(sigma_k=)`` takes the (K,) sigma_k as any
array.

``consensus_problem_from_numpy`` carries the reference's row-partitioned
``ConsensusProblem`` (its arrays as numpy) across for the baselines.

For the model zoo: ``model_params_from_numpy`` takes the reference's
parameter pytree as numpy arrays (layer-stacked, as ``_stack_init`` builds
it), ``load_checkpoint`` reads an npz written by the reference's
``train.checkpoint.save`` (leaves keyed by ``jax.tree_util.keystr`` paths,
parsed here as strings), and ``cache_to_numpy`` hands a KV cache back.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.core.baselines import ConsensusProblem
from repro_torch.core.cola import ColaState
from repro_torch.core.problems import PROBLEMS, Problem
from repro_torch.device import resolve
from repro_torch.models import transformer


def problem_from_numpy(name: str, x, y, lam: float, *, device,
                       **kw) -> Problem:
    """``PROBLEMS[name]`` built from numpy data on ``device`` — the same
    arguments ``repro.core.problems.PROBLEMS[name]`` takes."""
    return PROBLEMS[name](np.asarray(x), np.asarray(y), lam, device=device,
                          **kw)


def state_from_numpy(x_parts, v_stack, *, device) -> ColaState:
    """A ``ColaState`` from (K, n_k) / (K, d) arrays."""
    dev = resolve(device)
    return ColaState(x_parts=torch.as_tensor(np.asarray(x_parts), device=dev),
                     v_stack=torch.as_tensor(np.asarray(v_stack), device=dev))


def state_to_numpy(state: ColaState) -> tuple[np.ndarray, np.ndarray]:
    """(x_parts, v_stack) as numpy arrays."""
    return state.x_parts.cpu().numpy(), state.v_stack.cpu().numpy()


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


def _tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _param_paths(name: str):
    """Module parameter name -> (path in the reference tree, layer index or
    None): ``layers.3.attn.wq`` -> (("layers", "attn", "wq"), 3)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("layers",) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def model_params_from_numpy(cfg, tree, *, device) -> transformer.Transformer:
    """The port's parameters from the reference's parameter pytree as numpy
    (``jax.tree.map(np.asarray, params)``): the layer leaves carry a leading
    (num_layers,) axis. Every leaf is cast to ``cfg.dtype``; a missing,
    extra or misshapen leaf raises."""
    dev = resolve(device)
    params = transformer.init_params(cfg, None, dev)
    expected = set()
    with torch.no_grad():
        for name, p in params.named_parameters():
            path, layer = _param_paths(name)
            expected.add(path)
            try:
                arr = _tree_get(tree, path)
            except (KeyError, IndexError, TypeError):
                raise KeyError(f"parameter tree has no leaf {path}") from None
            arr = np.asarray(arr)
            if layer is not None:
                if arr.shape[0] != cfg.num_layers:
                    raise ValueError(f"{path}: leading axis {arr.shape[0]} "
                                     f"!= num_layers {cfg.num_layers}")
                arr = arr[layer]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    extra = sorted(str(path) for path, _ in _tree_leaves(tree)
                   if path not in expected)
    if extra:
        raise ValueError(f"parameter tree has leaves the model lacks: {extra}")
    return params


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


def cache_to_numpy(cache: dict) -> dict:
    """A KV cache as numpy in the reference's layout (k, v as float32 —
    numpy has no bf16 — and pos as int32)."""
    return {key: (t.float() if t.is_floating_point() else t).cpu().numpy()
            for key, t in cache.items()}
