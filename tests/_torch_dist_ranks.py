"""Multi-rank runs of ``repro_torch.dist.run_dist_cola`` on gloo, for
``tests/test_torch_dist_ranks.py``.

    PYTHONPATH=src python tests/_torch_dist_ranks.py OUT_DIR GROUP

runs the cases of ``CASES`` in ``GROUP`` ("mix" or "cert"): for each
world size they name, it spawns that many ranks, which rendezvous through
a file under OUT_DIR. Rank 0 also runs the port's ``run_cola`` on the
same inputs, and writes ``OUT_DIR/<world>_<case>.npz``: the distributed
and the stacked final states, both histories and the distributed run's
collective counts (JSON). The "cert" group also writes the counts of one
mixing step and one certificate record on each plan path
(``<world>_probe.json``, ``budget_probe``). Imports the port only.
"""
from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np

K = 8


def _drop(t, rng):
    return rng.random(K) < 0.7


def _drop4(t, rng):
    return rng.random(4) < 0.75


def _budgets(t, rng):
    b = np.full(K, 16)
    b[rng.random(K) < 0.5] = 4
    return b


def data(kind: str):
    """(problem name, x, y, lam, kwargs): the data of the reference's
    ``tests/test_dist_parity.py`` fixtures."""
    from repro_torch.data import synthetic
    if kind == "ridge":
        x, y, _ = synthetic.regression(150, 48, seed=4)
        return "ridge_primal", x, y, 1e-2, {}
    x, y, _ = synthetic.regression(150, 48, seed=2, sparsity_solution=0.2)
    return "lasso", x, y, 5e-2, {"box": 5.0}


def _case(data="ridge", graph=("torus_2d", (2, 4)), cfg=None, rounds=25,
          worlds=(2, 4), claim="bitwise", group="mix", **run):
    base = dict(comm="plan", record_every=6, seed=3)
    return dict(data=data, graph=graph, cfg=cfg or {"kappa": 1.0},
                rounds=rounds, worlds=worlds, claim=claim, group=group,
                run={**base, **run})


CERT = dict(data="lasso", cfg={"kappa": 8.0}, rounds=400, record_every=20,
            recorder="certificate", eps=0.1, group="cert")

# claim: "bitwise" (state and history equal the port's run_cola bit for bit)
# or "rtol" (within rtol 1e-6 and atol 1e-6 max|value|). The rtol cases:
# a cross-rank psum (the leaver reset's node sum), the block plan's B
# sequential steps against run_cola's folded W^B, or one node per rank (a
# batch of one takes a BLAS's matrix-vector path, another summation order).
# The certificate's consensus_residual always adds across ranks, so its
# history is held at rtol.
CASES = {
    "plan_static": _case(),
    "dense_static": _case(comm="dense"),
    "ring_dispatch_torus": _case(comm="ring"),
    "ring_dispatch_ring": _case(graph=("ring", (K,)), comm="ring"),
    "churn_freeze": _case(active_schedule=_drop),
    "churn_reset": _case(active_schedule=_drop, leave_mode="reset",
                         claim="rtol"),
    "churn_reset_dense": _case(active_schedule=_drop, leave_mode="reset",
                               comm="dense", claim="rtol"),
    "budgets": _case(budget_schedule=_budgets),
    "churn_budgets_reset": _case(active_schedule=_drop,
                                 budget_schedule=_budgets,
                                 leave_mode="reset", claim="rtol"),
    "gossip2": _case(cfg={"kappa": 0.5, "gossip_steps": 2}, claim="rtol"),
    "gossip2_dense": _case(cfg={"kappa": 0.5, "gossip_steps": 2},
                           comm="dense"),
    "residual": _case(cfg={"kappa": 1.0, "cd_mode": "residual"}),
    "mixed": _case(cfg={"kappa": 1.0, "grad_mode": "mixed"}),
    "w_override": _case(graph=("ring", (K,)), w_override="cycle2"),
    "adaptive": _case(rounds=40, record_every="adaptive", eps=1e-2),
    "cert_stop": _case(**CERT),
    "cert_churn": _case(**dict(CERT, rounds=300, eps=10.0),
                        active_schedule=_drop, seed=11),
    "gap_cert_dense": _case(**dict(CERT, rounds=200, record_every=50,
                                   recorder="gap+certificate"),
                            comm="dense"),
    "odd_complete": _case(graph=("complete", (9,)), worlds=(3,),
                          group="cert"),
    "per_node_ring_cert": _case(graph=("ring", (4,)), worlds=(4,),
                                claim="rtol", comm="ring", **CERT),
    "per_node_plan_cert_churn": _case(
        graph=("torus_2d", (2, 2)), worlds=(4,), claim="rtol",
        **dict(CERT, rounds=300, eps=10.0), active_schedule=_drop4,
        seed=11),
    "per_node_plan_churn": _case(graph=("torus_2d", (2, 2)), worlds=(4,),
                                 claim="rtol", rounds=15, record_every=3,
                                 active_schedule=_drop4, seed=5,
                                 group="cert"),
    "per_node_dense": _case(graph=("torus_2d", (2, 2)), worlds=(4,),
                            claim="rtol", comm="dense", group="cert"),
}


def exact_sigma(a_parts: np.ndarray) -> np.ndarray:
    """The certificate's sigma_k = ||A_[k]||_2^2, exact: the reference's
    power iteration starts from ``jax.random`` and the port's from a
    ``torch.Generator``, so parity hands both packages these values (as
    ``tests/test_torch_cola.py`` does)."""
    return np.array([np.linalg.norm(a, 2) ** 2 for a in a_parts],
                    dtype=np.float32)


def build(case: dict, device="cpu"):
    """(port problem, graph, cfg, run_cola kwargs) of a case; a
    certificate recorder is built with the exact sigma_k."""
    from repro_torch import convert
    from repro_torch.core import cola, metrics, topology as topo
    from repro_torch.core.partition import make_partition
    name, x, y, lam, kw = data(case["data"])
    prob = convert.problem_from_numpy(name, x, y, lam, device=device, **kw)
    gname, args = case["graph"]
    graph = getattr(topo, gname)(*args)
    run = dict(case["run"])
    if run.get("w_override") == "cycle2":
        run["w_override"] = topo.metropolis_weights(
            topo.connected_cycle(graph.num_nodes, 2))
    if "certificate" in run.get("recorder", ""):
        part = make_partition(prob.n, graph.num_nodes)
        env = cola.build_env(prob, part)
        cert = metrics.certificate_recorder(
            prob, part, env, graph, run["eps"],
            sigma_k=exact_sigma(env.a_parts.numpy()))
        run["recorder"] = (cert if run["recorder"] == "certificate" else
                           metrics.ComposedRecorder(
                               (metrics.GapRecorder(prob, part), cert)))
    return prob, graph, cola.ColaConfig(**case["cfg"]), run


def run_cases(rank: int, world: int, out_dir: str, group: str) -> None:
    from repro_torch.core import cola
    from repro_torch.dist import NodeAxis, run_dist_cola
    axis = NodeAxis()
    for name, case in CASES.items():
        if world not in case["worlds"] or case["group"] != group:
            continue
        prob, graph, cfg, run = build(case)
        comm = run.pop("comm")
        axis.reset_counts()
        res = run_dist_cola(prob, graph, cfg, axis, case["rounds"],
                            comm=comm, device="cpu", block_size=16, **run)
        counts = {"calls": dict(axis.counts),
                  "sent": dict(axis.sent_bytes)}
        extra = {}
        if name == "cert_stop" and res.history["stop_round"] is not None:
            # the stopped state against a run of stop_round + 1 rounds
            trunc = run_dist_cola(prob, graph, cfg, axis,
                                  res.history["stop_round"] + 1, comm=comm,
                                  device="cpu", block_size=16,
                                  record_every=20)
            extra = {"x_trunc": trunc.state.x_parts.numpy(),
                     "v_trunc": trunc.state.v_stack.numpy()}
        if rank != 0:
            continue
        sim = cola.run_cola(prob, graph, cfg, case["rounds"], device="cpu",
                            block_size=16, **run)
        np.savez(os.path.join(out_dir, f"{world}_{name}.npz"),
                 x=res.state.x_parts.numpy(), v=res.state.v_stack.numpy(),
                 x_sim=sim.state.x_parts.numpy(),
                 v_sim=sim.state.v_stack.numpy(),
                 history=json.dumps(res.history),
                 history_sim=json.dumps(sim.history),
                 counts=json.dumps(counts), **extra)
    if group == "cert":
        budget_probe(rank, world, out_dir, axis)


def budget_probe(rank: int, world: int, out_dir: str, axis) -> None:
    """The collective counts of one gossip step and one certificate record
    on each plan path, beside the plan's budget."""
    import torch
    from repro_torch.core import cola, metrics, topology as topo
    from repro_torch.core.partition import make_partition
    from repro_torch.dist import runtime, sharding
    from repro_torch.topo import lowering, plan as tplan
    d = 48
    graphs = {"torus": topo.torus_2d(2, 4), "complete": topo.complete(K)}
    if world == 3:
        graphs = {"complete9": topo.complete(9)}
    if world == 4:
        graphs["node_torus"] = topo.torus_2d(2, 2)
    out = {}
    gen = torch.Generator().manual_seed(0)
    for gname, graph in graphs.items():
        k = graph.num_nodes
        ln = k // world
        pl = (tplan.compile_plan(graph) if ln == 1
              else tplan.compile_block_plan(graph, world))
        w = torch.as_tensor(topo.metropolis_weights(graph),
                            dtype=torch.float32)
        v = torch.randn((ln, d), generator=gen)
        axis.reset_counts()
        for _ in range(2):          # gossip_steps = 2
            if ln == 1:
                diag, coefs = tplan.plan_coefficients(pl, w.numpy())
                i = axis.index
                lowering.plan_mix_step(v[0], axis, pl,
                                       torch.as_tensor(diag[i]),
                                       torch.as_tensor(coefs[:, i]))
            else:
                lowering.block_mix_step(v, axis, pl,
                                        sharding.node_block(w, axis))
        mix = {"calls": dict(axis.counts), "sent": dict(axis.sent_bytes)}
        # one certificate record through the runtime's record program
        name, x, y, lam, kw = data("lasso")
        from repro_torch import convert
        prob = convert.problem_from_numpy(name, x, y, lam, device="cpu",
                                          **kw)
        part = make_partition(prob.n, k)
        env = cola.build_env(prob, part)
        rec = metrics.make_recorder("certificate", prob, part, env, graph,
                                    topo.metropolis_weights(graph), 0.1)
        record = runtime._dist_record_fn(
            rec, axis, ln, "plan", 1, sharding.cola_env_block(env, axis), pl)
        state = sharding.cola_state_block(cola.init_state(prob, part), axis)
        state = state._replace(v_stack=torch.randn(state.v_stack.shape,
                                                   generator=gen))
        axis.reset_counts()
        record(state)
        cert = {"calls": dict(axis.counts), "sent": dict(axis.sent_bytes)}
        out[gname] = {"k": k, "ln": ln, "d": d, "d_cert": prob.d,
                      "colors": pl.num_colors,
                      "budget": lowering.comm_budget(pl, d, 4,
                                                     gossip_steps=2),
                      "contract": pl.contract(d, 4,
                                              gossip_steps=2).describe(),
                      "mix": mix, "cert": cert}
        if ln > 1:
            out[gname]["delta_block"] = int(pl.block.support().sum(1).max())
    if rank == 0:
        with open(os.path.join(out_dir, f"{world}_probe.json"), "w") as f:
            json.dump(out, f)


def worlds_of(group: str) -> list:
    return sorted({w for c in CASES.values() if c["group"] == group
                   for w in c["worlds"]})


def _rank(rank: int, world: int, out_dir: str, group: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    # a collective that waits past the timeout raises on every rank: a
    # deadlock fails the run instead of hanging it
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store_{group}_{world}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=120))
    try:
        run_cases(rank, world, out_dir, group)
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    import torch.multiprocessing as mp
    out_dir, group = os.path.abspath(argv[0]), argv[1]
    for world in worlds_of(group):
        mp.spawn(_rank, args=(world, out_dir, group), nprocs=world)
    print("DIST_RANKS_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
