"""Expert-parallel MoE (``models.mlp.moe_apply`` with ``mesh`` and
``model_axis``) over 2 and 4 gloo ranks, against one process and the
reference.

One subprocess (``tests/_torch_dist_ranks.py``, group "ep") spawns the
ranks of each world size; the fixture first writes each case's inputs:
the reference's ``moe_init`` weights of the dbrx and llama4 smoke
variants (drawn by JAX, carried as numpy), x (B, S, d) and an output
cotangent from a numpy seed. Claims:

* y and aux of every rank within rtol 1e-6 (atol 1e-6 x max|y|) of the
  port's single-process ``moe_apply`` (dbrx's top-2 sums two experts'
  outputs on two ranks, so in another order);
* y and aux against the reference: the sum over ranks of its
  ``_scatter_moe_local`` on the rank's expert block (what its
  ``shard_map`` branch psums) plus the shared expert, and its own
  single-device ``moe_apply``, at ``tests/test_torch_moe.py``'s bars
  (atol 3e-5, rtol 1e-4: fp32 products summed by another library);
* gradients of sum(y * cot) + aux: each rank's expert leaves hold its
  slice of the single-process gradient and zeros elsewhere; the router's,
  the shared expert's and x's gradients are whole on every rank; rtol
  1e-6 (atol 1e-6 x max|g|);
* the axis's counts: one all-reduce of T x d elements in the forward,
  two in the backward (the x and w_topk cotangents: T x d and T x k);
* the "drop" case drops pairs (an expert's load exceeds its capacity).
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_ranks as ranks
from repro.configs.base import get_config as jget, smoke_variant as jsmoke
from repro.models import mlp as jmlp
from test_torch_dist_ranks import run_group

B, S = 2, 12
EP_RTOL = 1e-6
REF_ATOL, REF_RTOL = 3e-5, 1e-4
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _cfg(case: str):
    return jsmoke(jget(ranks.EP_CASES[case]["arch"]))


def _inputs(case: str) -> dict:
    cfg = _cfg(case)
    p = jmlp.moe_init(jax.random.PRNGKey(7), cfg.d_model, cfg.d_ff,
                      cfg.num_experts, jnp.float32,
                      shared_expert=cfg.moe_shared_expert)
    out = {f"p.{n}": np.asarray(v) for n, v in p.items() if n != "shared"}
    out.update({f"p.shared.{n}": np.asarray(v)
                for n, v in p.get("shared", {}).items()})
    rng = np.random.default_rng(11)
    out["x"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    out["cot"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ep_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_ep_inputs")
    for case in ranks.EP_CASES:
        np.savez(out / f"ep_{case}.npz", **_inputs(case))
    return run_group(tmp_path_factory, "ep", inputs=out)


def _load(out, case: str, world: int, rank: int) -> dict:
    return dict(np.load(out / f"{world}_ep_{case}_{rank}.npz"))


def _close(a, b, rtol=EP_RTOL, err_msg=""):
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * float(np.abs(b).max()),
                               err_msg=err_msg)


CASES = [(case, world) for case in ranks.EP_CASES
         for world in ranks.EP_WORLDS]


@pytest.mark.parametrize("case,world", CASES)
def test_expert_parallel_matches_one_process(ep_out, case, world):
    single = _load(ep_out, case, world, 0)
    e = single["single.grad.w_gate"].shape[0]
    e_loc = e // world
    for rank in range(world):
        res = _load(ep_out, case, world, rank)
        _close(res["y"], single["single.y"], err_msg=f"y rank {rank}")
        _close(res["aux"], single["single.aux"], err_msg="aux")
        for name in (n for n in single if n.startswith("single.grad.")):
            leaf = name[len("single.grad."):]
            g, want = res[f"grad.{leaf}"], single[name]
            if leaf in EXPERT_LEAVES:
                rows = slice(rank * e_loc, (rank + 1) * e_loc)
                _close(g[rows], want[rows], err_msg=f"{leaf} rank {rank}")
                rest = np.delete(g, np.arange(e)[rows], axis=0)
                assert not rest.any(), (leaf, rank)
            else:
                _close(g, want, err_msg=f"{leaf} rank {rank}")


@pytest.mark.parametrize("case,world", CASES)
def test_expert_parallel_matches_reference(ep_out, case, world):
    cfg = _cfg(case)
    inputs = _inputs(case)
    k, cf = ranks.ep_layer(case)
    p = {n[2:]: jnp.asarray(v) for n, v in inputs.items()
         if n.startswith("p.") and not n.startswith("p.shared.")}
    if cfg.moe_shared_expert:
        p["shared"] = {n[len("p.shared."):]: jnp.asarray(v)
                       for n, v in inputs.items()
                       if n.startswith("p.shared.")}
    x = jnp.asarray(inputs["x"])
    y_ref, aux_ref = jmlp.moe_apply(p, x, experts_per_token=k,
                                    capacity_factor=cf, mode="scatter")
    x_flat = x.reshape(B * S, -1)
    w_topk, idx, _ = jmlp._router(p, x_flat, k)
    e = cfg.num_experts
    e_loc = e // world
    capacity = max(1, int(round(B * S * k / e * cf)))
    parts = sum(jmlp._scatter_moe_local(
        p["w_gate"][r * e_loc:(r + 1) * e_loc],
        p["w_up"][r * e_loc:(r + 1) * e_loc],
        p["w_down"][r * e_loc:(r + 1) * e_loc], x_flat, w_topk, idx,
        capacity, r * e_loc, e_loc) for r in range(world))
    if cfg.moe_shared_expert:
        parts = parts + jmlp.mlp_apply(p["shared"], x_flat)
    res = _load(ep_out, case, world, world - 1)
    for want in (parts.reshape(y_ref.shape), y_ref):
        np.testing.assert_allclose(res["y"], np.asarray(want), atol=REF_ATOL,
                                   rtol=REF_RTOL)
    np.testing.assert_allclose(res["aux"], float(aux_ref), atol=1e-6)
    # routes: every pair's expert as the reference routes it
    load = np.bincount(np.asarray(idx).reshape(-1), minlength=e)
    if ranks.EP_CASES[case]["capacity_factor"]:
        assert load.max() > capacity, (load, capacity)


@pytest.mark.parametrize("case,world", CASES)
def test_expert_parallel_collective_counts(ep_out, case, world):
    cfg = _cfg(case)
    k, _ = ranks.ep_layer(case)
    t, d = B * S, cfg.d_model
    for rank in range(world):
        counts = json.loads(str(_load(ep_out, case, world, rank)["counts"]))
        assert counts["fwd_calls"] == {"all-reduce": 1}
        assert counts["fwd_sent"] == {"all-reduce": 4 * t * d}
        assert counts["bwd_calls"] == {"all-reduce": 2}
        assert counts["bwd_sent"] == {"all-reduce": 4 * (t * d + t * k)}
