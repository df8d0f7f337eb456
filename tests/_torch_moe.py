"""Helpers of the parity tests (``tests/test_torch_moe.py``,
``test_torch_models.py``, ``test_torch_serve.py``,
``test_torch_moe_train.py``).

``frontend_np`` draws an encdec or vlm model's input beside its tokens.

``RouteLog`` records every router call of both packages: the reference's
top-k indices through a ``jax.debug.callback`` (the router runs inside
``lax.scan``), the port's indices and the margin between its k-th and
(k+1)-th probability. ``check`` asserts that the two packages routed every
token to the same experts in the same order, and that no margin was within
``MARGIN`` of a tie, so that a near-tie can neither flip unseen nor be
blamed on the port (``torch.topk`` and ``lax.top_k`` may order near-ties
differently).
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.models import mlp as jmlp
from repro_torch.models import mlp as tmlp

MARGIN = 1e-5


class RouteLog:
    """Patches both routers (``monkeypatch``) and records their calls."""

    def __init__(self, monkeypatch):
        self.ref, self.port, self.margins = [], [], []
        jrouter, trouter = jmlp._router, tmlp._router

        def ref_router(p, x_flat, k):
            w, idx, aux = jrouter(p, x_flat, k)
            jax.debug.callback(lambda i: self.ref.append(np.asarray(i)),
                               idx, ordered=True)
            return w, idx, aux

        def port_router(p, x_flat, k):
            w, idx, aux = trouter(p, x_flat, k)
            probs = torch.softmax(x_flat.float() @ p["router"].float(), -1)
            top = torch.topk(probs, min(k + 1, probs.shape[-1]), dim=-1)[0]
            if k < probs.shape[-1]:
                self.margins.append(float((top[:, k - 1] - top[:, k]).min()))
            self.port.append(idx.numpy())
            return w, idx, aux

        monkeypatch.setattr(jmlp, "_router", ref_router)
        monkeypatch.setattr(tmlp, "_router", port_router)

    def check(self, calls: int | None = None) -> None:
        jax.effects_barrier()
        assert len(self.ref) == len(self.port) > 0
        if calls is not None:
            assert len(self.port) == calls
        for i, (r, p) in enumerate(zip(self.ref, self.port)):
            np.testing.assert_array_equal(p, r, err_msg=f"router call {i}")
        assert not self.margins or min(self.margins) > MARGIN, self.margins
        self.ref.clear()
        self.port.clear()
        self.margins.clear()


def frontend_np(cfg, b: int, enc_len: int, seed: int) -> dict:
    """The family's frontend input as numpy, standard normal from
    ``seed``: vlm patches (b, num_prefix_tokens, F), encdec frame
    embeddings (b, enc_len, F); {} for the token-only families."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        shape, key = (b, cfg.num_prefix_tokens, cfg.frontend_dim), "patches"
    elif cfg.family == "encdec":
        shape, key = (b, enc_len, cfg.frontend_dim), "enc_embeds"
    else:
        return {}
    return {key: rng.normal(size=shape).astype(np.float32)}


def ref_cache_to_port(cfg, cache) -> dict:
    """The reference's cache as numpy in the port's layout: one stacked
    entry per attention layer. An interleaved MoE group's nested
    ``{"dense": [...], "moe": ...}`` (each leaf (groups, ...)) becomes
    layers g * moe_every + j, the group's dense layers first."""
    cache = jax.tree.map(np.asarray, cache)
    if not (cfg.family == "moe" and cfg.moe_every > 1):
        return cache
    layers = list(cache["dense"]) + [cache["moe"]]
    return {key: np.stack([lay[key] for lay in layers], axis=1).reshape(
        (-1,) + layers[0][key].shape[1:]) for key in ("k", "v", "pos")}
