"""Path-keyed npz checkpoints (counterpart of ``repro.train.checkpoint``).

Leaves are stored under the reference's ``jax.tree_util.keystr`` paths:
``['embed']`` for a dict key, ``[0]`` for a list or tuple index,
``.params`` for a NamedTuple field. A dotted key of the port's flat
parameter dicts (``"layers.attn.wq"``) is a nested path
(``['layers']['attn']['wq']``; a numeric part, ``"layers.dense.0.ln1"``,
a list index), the reference's layout. So each package
restores the other's files: ``restore`` validates names and shapes against
a tree of the same structure.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _segments(key) -> list:
    if isinstance(key, str):
        # a numeric part of a dotted name is a list index
        # ("layers.dense.0.ln1" -> ['layers']['dense'][0]['ln1'])
        return [f"[{part}]" if part.isdigit() else f"['{part}']"
                for part in key.split(".")]
    return [f"[{key}]"]


def _flatten(tree: Any, prefix: str = ""):
    """(keystr, leaf) pairs in order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, dict):
        for key, val in tree.items():
            yield from _flatten(val, prefix + "".join(_segments(key)))
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from _flatten(val, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:   # numpy has no bf16
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any) -> None:
    """Write every leaf of ``tree`` (tensors or arrays) to an npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {key: _to_numpy(leaf) for key, leaf in _flatten(tree)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _rebuild(tree: Any, values: dict, prefix: str = ""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), values,
                                     f"{prefix}.{n}") for n in tree._fields))
    if isinstance(tree, dict):
        return {key: _rebuild(val, values, prefix + "".join(_segments(key)))
                for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(val, values, f"{prefix}[{i}]")
                          for i, val in enumerate(tree))
    return values[prefix]


def restore(path: str, like: Any) -> Any:
    """Load a checkpoint into the structure, dtypes and devices of
    ``like`` (tensors; numpy arrays stay numpy). A missing leaf or another
    shape raises."""
    with np.load(path) as data:
        stored = dict(data)
    values = {}
    for key, leaf in _flatten(like):
        if key not in stored:
            raise KeyError(f"checkpoint {path} is missing leaf {key}")
        arr = stored[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(np.shape(leaf))}")
        if isinstance(leaf, torch.Tensor):
            values[key] = torch.tensor(np.asarray(arr), device=leaf.device
                                       ).to(leaf.dtype)
        else:
            values[key] = np.asarray(arr, dtype=np.asarray(leaf).dtype)
    return _rebuild(like, values)
