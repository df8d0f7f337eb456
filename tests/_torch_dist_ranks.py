"""Multi-rank runs of ``repro_torch.dist.run_dist_cola`` on gloo, for
``tests/test_torch_dist_ranks.py``.

    PYTHONPATH=src python tests/_torch_dist_ranks.py OUT_DIR GROUP

runs the cases of ``CASES`` in ``GROUP`` ("mix", "cert" or "wire"): for
each world size they name, it spawns that many ranks, which rendezvous
through a file under OUT_DIR. Rank 0 also runs the port's ``run_cola`` on
the same inputs, and writes ``OUT_DIR/<world>_<case>.npz``: the
distributed and the stacked final states, both histories and the
distributed run's collective counts (JSON); a ``telemetry`` case also
runs with ``cfg.telemetry`` on (``x_on``, ``v_on``, ``history_on``,
``counts_on``, and rank 0's ``run_cola`` telemetry ``history_sim_on``).
Every rank runs with ``REPRO_RUNS_DIR=off``. The "cert" group also writes
the counts of one mixing step and one certificate record on each plan
path (``<world>_probe.json``, ``budget_probe``).

The "ep" group (expert-parallel MoE, ``models.mlp.moe_apply`` over the
model axis of ``launch.mesh.make_host_mesh(1, world)``) reads
``ep_<case>.npz`` (the weights, x and an output cotangent) for each case of
``EP_CASES``; each rank runs the layer forward and backward through the
axis and writes ``<world>_ep_<case>_<rank>.npz``: y, aux, every gradient
and the axis's all-reduce counts and bytes of the forward and of the
backward. Rank 0 also writes the single-process layer's (``single.*``).

The "wire" group (the quantized wire, robust mixing and attacks over
ranks) reads inputs the test wrote into OUT_DIR first: the reference's
stochastic-rounding uniforms of a case (``draws_<case>.npy``, (T + 1, B,
K, d)) and the gossip ring's initial replicas (``gossip_<K>.pt``, the
port's TrainState of K nodes, with ``gossip_<K>.npz`` batches). It also
writes one wire mix's counts per wire and comm (``<world>_wire_probe
.json``), each rank's env block against the whole env
(``<world>_env_<rank>.json``) and the gossip ring's results
(``<world>_gossip_<rank>.npz``). Imports the port only.
"""
from __future__ import annotations

import dataclasses
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
          worlds=(2, 4), claim="bitwise", group="mix", probe=False,
          ref_draws=False, telemetry=False, **run):
    base = dict(comm="plan", record_every=6, seed=3)
    return dict(data=data, graph=graph, cfg=cfg or {"kappa": 1.0},
                rounds=rounds, worlds=worlds, claim=claim, group=group,
                probe=probe, ref_draws=ref_draws, telemetry=telemetry,
                run={**base, **run})


def attacks_of(spec, pkg):
    """The scenario list of an attack ``spec`` in ``pkg`` (the port's
    ``repro_torch.attack`` or the reference's ``repro.attack``)."""
    if spec == "sign_flip":
        return [pkg.Byzantine(nodes=(1, 6), mode="sign_flip", scale=10.0,
                              start=5, seed=1)]
    if spec == "sign_flip_4":
        return [pkg.Byzantine(nodes=(1,), mode="sign_flip", scale=10.0,
                              start=5, seed=1)]
    if spec == "free_rider":
        return [pkg.FreeRider(nodes=(2,)),
                pkg.FreeRider(nodes=(5,), stale=True, start=10)]
    if spec == "link_identity":
        return [pkg.LinkCorruption(edges=((0, 1),), scale=1.0)]
    raise ValueError(spec)


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

# The "wire" group. Claims as above, plus "flip" (one node per rank on the
# quantized wire: the local solve's batch-1 products part from run_cola's
# in the last bits, so stochastic rounding may take the other grid step;
# held with tests/test_torch_quant.py's flip-aware tolerance). The attacked
# clip run holds at rtol (its square-root chain, as the reference's own
# clip pin); on the wire clip is bitwise (a 1-ulp change would flip a
# rounding draw, so nothing weaker could hold). Wire
# cases record a probe of v and replay the reference's uniforms
# (``ref_draws``). Attack cases: run_a's attack of the reference's
# tests/test_dist_plan.py:296 on its lasso, gap + the honest-cohort
# certificate.
WIRE = dict(group="wire", probe=True, ref_draws=True)
ATK = dict(group="wire", data="lasso", cfg={"kappa": 2.0}, rounds=60,
           record_every=10, recorder="gap+certificate", eps=1.0,
           attacks="sign_flip")
CASES.update({
    "int8_ef": _case(cfg={"kappa": 1.0, "wire": "int8"}, **WIRE),
    "int8_ef_dense": _case(cfg={"kappa": 1.0, "wire": "int8"},
                           comm="dense", **WIRE),
    "fp8_pipe": _case(cfg={"kappa": 1.0, "wire": "fp8", "pipeline": True},
                      **WIRE),
    "e5m2_no_ef": _case(cfg={"kappa": 1.0, "wire": "fp8_e5m2",
                             "error_feedback": False}, **WIRE),
    "trim_int8": _case(cfg={"kappa": 1.0, "wire": "int8", "robust": "trim"},
                       **WIRE),
    "trim_int8_dense": _case(cfg={"kappa": 1.0, "wire": "int8",
                                  "robust": "trim"}, comm="dense", **WIRE),
    "median_int8": _case(cfg={"kappa": 1.0, "wire": "int8",
                              "robust": "median"}, **WIRE),
    "clip_int8_dense": _case(cfg={"kappa": 1.0, "wire": "int8",
                                  "robust": "clip"}, comm="dense", **WIRE),
    "clip_int8": _case(cfg={"kappa": 1.0, "wire": "int8", "robust": "clip"},
                       **WIRE),
    "trim_sign_flip": _case(**dict(ATK, cfg={"kappa": 2.0,
                                             "robust": "trim"})),
    "trim_sign_flip_dense": _case(**dict(ATK, cfg={"kappa": 2.0,
                                                   "robust": "trim"}),
                                  comm="dense"),
    "median_sign_flip": _case(**dict(ATK, cfg={"kappa": 2.0,
                                               "robust": "median"})),
    "clip_sign_flip": _case(**dict(ATK, cfg={"kappa": 2.0,
                                             "robust": "clip"}, rounds=20),
                            claim="rtol"),
    "sign_flip": _case(**dict(ATK, rounds=20)),
    "free_rider": _case(**dict(ATK, rounds=30, recorder="gap",
                               attacks="free_rider")),
    "link_identity": _case(**dict(ATK, rounds=12, recorder="gap",
                                  attacks="link_identity")),
    "per_node_int8": _case(graph=("torus_2d", (2, 2)), worlds=(4,),
                           cfg={"kappa": 1.0, "wire": "int8"}, comm="ring",
                           claim="flip", **WIRE),
    # undefended, the lie grows the state every round and with it the
    # last-bit differences of one node per rank: three attacked rounds
    # (as the reference pins its clip run before the growth)
    "per_node_ring_sign_flip": _case(
        **dict(ATK, graph=("ring", (4,)), worlds=(4,), rounds=8,
               record_every=2, recorder="gap", attacks="sign_flip_4"),
        comm="ring", claim="rtol"),
    "per_node_plan_sign_flip": _case(
        **dict(ATK, graph=("torus_2d", (2, 2)), worlds=(4,), rounds=8,
               record_every=2, recorder="gap", attacks="sign_flip_4"),
        claim="rtol"),
    "per_node_trim_sign_flip": _case(
        **dict(ATK, graph=("torus_2d", (2, 2)), worlds=(4,), rounds=20,
               cfg={"kappa": 2.0, "robust": "trim"},
               attacks="sign_flip_4"), comm="ring", claim="rtol"),
    # telemetry over ranks: each run again with the counters on (bitwise
    # the run without them), no early stop, so every round counts
    "tel_fp32": _case(group="wire", telemetry=True),
    "tel_int8": _case(cfg={"kappa": 1.0, "wire": "int8"}, group="wire",
                      telemetry=True),
    "tel_trim_sign_flip": _case(
        **dict(ATK, cfg={"kappa": 2.0, "robust": "trim"}, rounds=20,
               recorder="gap", eps=None), telemetry=True),
})


def exact_sigma(a_parts: np.ndarray) -> np.ndarray:
    """The certificate's sigma_k = ||A_[k]||_2^2, exact: the reference's
    power iteration starts from ``jax.random`` and the port's from a
    ``torch.Generator``, so parity hands both packages these values (as
    ``tests/test_torch_cola.py`` does)."""
    return np.array([np.linalg.norm(a, 2) ** 2 for a in a_parts],
                    dtype=np.float32)


def probe_weights(k: int, d: int) -> np.ndarray:
    """The state probe's fixed projection (tests/test_torch_quant.py's
    ``_probe``)."""
    return np.random.default_rng(99).standard_normal((k, d)).astype(
        np.float32)


def build(case: dict, device="cpu", case_name=None, out_dir=None):
    """(port problem, graph, cfg, run_cola kwargs) of a case; a
    certificate recorder is built with the exact sigma_k; a wire case
    composes the gap recorder with the probe of v and replays the
    reference's uniforms from ``out_dir``."""
    import torch
    from repro_torch import attack, convert
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
    if case["probe"]:
        part = make_partition(prob.n, graph.num_nodes)
        p = torch.as_tensor(probe_weights(graph.num_nodes, prob.d))
        run["recorder"] = metrics.ComposedRecorder((
            metrics.GapRecorder(prob, part),
            metrics.FnRecorder(("probe",), lambda s, p=p:
                               torch.sum(s.v_stack * p)[None])))
    if case["ref_draws"]:
        arr = np.load(os.path.join(out_dir, f"draws_{case_name}.npy"))
        run["wire_draws"] = lambda t, step: torch.as_tensor(arr[t, step])
    if "attacks" in run:
        run["attacks"] = attacks_of(run["attacks"], attack)
    return prob, graph, cola.ColaConfig(**case["cfg"]), run


def run_cases(rank: int, world: int, out_dir: str, group: str) -> None:
    from repro_torch.core import cola
    from repro_torch.dist import NodeAxis, run_dist_cola
    axis = NodeAxis()
    for name, case in CASES.items():
        if world not in case["worlds"] or case["group"] != group:
            continue
        prob, graph, cfg, run = build(case, case_name=name, out_dir=out_dir)
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
        if case["telemetry"]:
            cfg_on = dataclasses.replace(cfg, telemetry=True)
            axis.reset_counts()
            on = run_dist_cola(prob, graph, cfg_on, axis, case["rounds"],
                               comm=comm, device="cpu", block_size=16, **run)
            extra = {"x_on": on.state.x_parts.numpy(),
                     "v_on": on.state.v_stack.numpy(),
                     "history_on": json.dumps(on.history),
                     "counts_on": json.dumps(
                         {"calls": dict(axis.counts),
                          "sent": dict(axis.sent_bytes)})}
            if rank == 0:
                extra["history_sim_on"] = json.dumps(cola.run_cola(
                    prob, graph, cfg_on, case["rounds"], device="cpu",
                    block_size=16, **run).history)
        if rank != 0:
            continue
        sim = cola.run_cola(prob, graph, cfg, case["rounds"], device="cpu",
                            block_size=16, **run)
        if res.state.ef is not None:
            extra.update(ef=res.state.ef.numpy(),
                         ef_sim=sim.state.ef.numpy())
        np.savez(os.path.join(out_dir, f"{world}_{name}.npz"),
                 x=res.state.x_parts.numpy(), v=res.state.v_stack.numpy(),
                 x_sim=sim.state.x_parts.numpy(),
                 v_sim=sim.state.v_stack.numpy(),
                 history=json.dumps(res.history),
                 history_sim=json.dumps(sim.history),
                 counts=json.dumps(counts), **extra)
    if group == "cert":
        budget_probe(rank, world, out_dir, axis)
    if group == "wire":
        wire_probe(rank, world, out_dir, axis)
        env_probe(rank, world, out_dir, axis)
        gossip_probe(rank, world, out_dir, axis)


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
            rec, axis, ln, "plan", 1,
            sharding.cola_env_block(prob, part, axis), pl)
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


def wire_probe(rank: int, world: int, out_dir: str, axis) -> None:
    """The counts of one quantized gossip round's mix on each comm (the
    runtime's ``_dist_qmixers``: block plan, dense, and the composed trim)
    on torus_2d(2, 4), and at 4 ranks on torus_2d(2, 2), one node per rank
    (the block plan ``run_dist_cola`` compiles for a wire there): its
    values against the stacked mix's rows."""
    import torch
    from repro_torch.core import cola, mixing, quant, topology as topo
    from repro_torch.dist import runtime, sharding
    from repro_torch.topo import plan as tplan
    d = 48
    gen = torch.Generator().manual_seed(1)
    out = {}
    layouts = [("torus", topo.torus_2d(2, 4))]
    if world == 4:
        layouts.append(("node_torus", topo.torus_2d(2, 2)))
    for gname, graph in layouts:
        k = graph.num_nodes
        w = torch.as_tensor(topo.metropolis_weights(graph),
                            dtype=torch.float32)
        v = torch.randn((k, d), generator=gen)
        ef = 0.01 * torch.randn((k, d), generator=gen)
        u = torch.rand((k, d), generator=gen)
        rows = sharding.node_rows(axis, k)
        draws = lambda s, u=u, rows=rows: u[rows]
        for wire in ("int8", "fp8"):
            for comm, robust in (("plan", None), ("dense", None),
                                 ("plan", "trim")):
                cfg = cola.ColaConfig(wire=wire, robust=robust)
                plan = (tplan.compile_block_plan(graph, world)
                        if comm == "plan" else None)
                payload = sharding.node_block(w, axis) if plan else w
                qmix = runtime._dist_qmixers(axis, comm, cfg, plan)
                axis.reset_counts()
                got, ef_got = qmix(payload, v[rows], ef[rows], draws, None)
                row = {"calls": dict(axis.counts),
                       "sent": dict(axis.sent_bytes), "ln": k // world,
                       "d": d, "k": k}
                if plan is not None:
                    row["contract_bytes"] = plan.contract(
                        d, wire=wire).max_collective_permute_bytes
                    row["contract_count"] = plan.contract(
                        d, wire=wire).max_collective_permute_count
                if robust is None:
                    want, ef_want = mixing.qmix_steps(
                        w, v, ef, 1, wire, lambda s: u)
                else:
                    _, _, deq, ef_want = quant.encode(v, wire, u, ef)
                    want = mixing.robust_mix_dense(w, deq, robust)
                want, ef_want = want[rows], ef_want[rows]
                row["bitwise"] = bool(torch.equal(got, want)
                                      and torch.equal(ef_got, ef_want))
                row["max_abs_diff"] = float((got - want).abs().max())
                out[f"{gname}:{wire}:{comm}:{robust}"] = row
    if rank == 0:
        with open(os.path.join(out_dir, f"{world}_wire_probe.json"),
                  "w") as f:
            json.dump(out, f)


def env_probe(rank: int, world: int, out_dir: str, axis) -> None:
    """Each rank's env, built from its own columns, against its rows of
    the whole env: equal bitwise, and 1/M of the whole one's storage."""
    from repro_torch import convert
    from repro_torch.core import cola
    from repro_torch.core.partition import make_partition
    from repro_torch.dist import sharding
    name, x, y, lam, kw = data("ridge")
    prob = convert.problem_from_numpy(name, x, y, lam, device="cpu", **kw)
    part = make_partition(prob.n, K)
    out = {}
    for with_gram in (True, False):
        whole = cola.build_env(prob, part, with_gram=with_gram)
        block = sharding.cola_env_block(prob, part, axis,
                                        with_gram=with_gram)
        for field, a, b in zip(whole._fields, block, whole):
            if b is None:
                out[f"{field}:{with_gram}"] = {"none": a is None}
                continue
            b_rows = sharding.node_block(b, axis)
            out[f"{field}:{with_gram}"] = {
                "bitwise": bool(a.shape == b_rows.shape
                                and (a == b_rows).all()),
                "storage": a.untyped_storage().nbytes(),
                "whole_storage": b.untyped_storage().nbytes()}
    with open(os.path.join(out_dir, f"{world}_env_{rank}.json"), "w") as f:
        json.dump(out, f)


GOSSIP_ROUNDS = 2


def _node_rows(tree, own: slice):
    """A copy of rows ``own`` of every tensor of a (K, ...)-stacked
    state."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree[own].clone()
    if isinstance(tree, dict):
        return {key: _node_rows(val, own) for key, val in tree.items()}
    return type(tree)(*(_node_rows(val, own) for val in tree))


def gossip_probe(rank: int, world: int, out_dir: str, axis) -> None:
    """The gossip ring over the ranks, K = M nodes, one per rank, at
    Qwen3-4B's smoke width with SGD + momentum (as
    tests/test_torch_gossip.py patches it): ``make_gossip_step(mesh=)``
    for ``GOSSIP_ROUNDS`` rounds from the test's replicas and batches, the
    block runner with a consensus recorder, and ``ring_mix_pytree``
    against ``mix_pytree``; rank 0 also runs the dense step and runner on
    all K nodes. Writes each rank's rows."""
    import torch
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core import topology as topo
    from repro_torch.optim import gossip, optimizers
    from repro_torch.train import steps
    k = world
    states = torch.load(os.path.join(out_dir, f"gossip_{k}.pt"),
                        weights_only=False)
    z = np.load(os.path.join(out_dir, f"gossip_{k}.npz"))
    batches = {key: torch.as_tensor(z[key]) for key in ("tokens", "labels")}
    steps._optimizer = lambda hp: optimizers.sgd_momentum(0.9)
    tcfg = smoke_variant(get_config("qwen3_4b"))
    local = steps.make_train_step(tcfg, steps.TrainHParams(lr=0.05))
    gcfg = gossip.GossipConfig(num_nodes=k, topology="ring")
    w = torch.as_tensor(gcfg.weights(), dtype=torch.float32)
    active = torch.ones((k,))
    own = slice(rank, rank + 1)
    mine = _node_rows(states, own)
    step = gossip.make_gossip_step(local, gcfg, mesh=axis)
    for t in range(GOSSIP_ROUNDS):
        step(mine, {key: b[t, own] for key, b in batches.items()}, w, active)
    res = {f"step.{n}": p.numpy() for n, p in mine.params.items()}
    # the block runner over the ranks, with the consensus distance
    mine = _node_rows(states, own)
    runner = gossip.make_gossip_block_runner(
        local, gcfg, mesh=axis, recorder=gossip.ConsensusRecorder())
    _, _, hist = runner(mine, {key: b[:, own].numpy()
                               for key, b in batches.items()},
                        np.broadcast_to(gcfg.weights(),
                                        (GOSSIP_ROUNDS, k, k)),
                        np.ones((GOSSIP_ROUNDS, k)),
                        np.ones((GOSSIP_ROUNDS,), bool), block_size=1)
    res.update({f"runner.{n}": p.numpy() for n, p in mine.params.items()})
    res["runner_distance"] = np.asarray(hist["consensus_distance"])
    # ring_mix_pytree on random leaves against mix_pytree's rows
    gen = torch.Generator().manual_seed(3)
    leaves = {"a": torch.randn((k, 6, 5), generator=gen),
              "b": torch.randn((k, 7), generator=gen)}
    band = torch.as_tensor(topo.metropolis_weights(topo.ring(k))[0, [-1 % k,
                                                                   0, 1]],
                           dtype=torch.float32)
    ring = gossip.ring_mix_pytree({n: p[own] for n, p in leaves.items()},
                                  axis, band, 1, steps=2)
    dense = gossip.mix_pytree(w, leaves, steps=2)
    res.update({f"ring.{n}": ring[n].numpy() for n in leaves})
    res.update({f"ring_dense.{n}": dense[n][own].numpy() for n in leaves})
    res["ring_calls"] = np.asarray(json.dumps(dict(axis.counts)))
    if rank == 0:
        full = torch.load(os.path.join(out_dir, f"gossip_{k}.pt"),
                          weights_only=False)
        dense_step = gossip.make_gossip_step(local, gcfg)
        for t in range(GOSSIP_ROUNDS):
            dense_step(full, {key: b[t] for key, b in batches.items()}, w,
                       active)
        res.update({f"dense.{n}": p.numpy() for n, p in full.params.items()})
        full = torch.load(os.path.join(out_dir, f"gossip_{k}.pt"),
                          weights_only=False)
        runner = gossip.make_gossip_block_runner(
            local, gcfg, recorder=gossip.ConsensusRecorder())
        _, _, hist = runner(full, {key: b.numpy()
                                   for key, b in batches.items()},
                            np.broadcast_to(gcfg.weights(),
                                            (GOSSIP_ROUNDS, k, k)),
                            np.ones((GOSSIP_ROUNDS, k)),
                            np.ones((GOSSIP_ROUNDS,), bool), block_size=1)
        res["dense_runner_distance"] = np.asarray(
            hist["consensus_distance"])
    np.savez(os.path.join(out_dir, f"{world}_gossip_{rank}.npz"), **res)


# expert parallelism: the smoke variants' MoE layers, scatter mode; the
# "drop" case at capacity factor 0.5 drops pairs
EP_CASES = {"dbrx": dict(arch="dbrx_132b", capacity_factor=None),
            "llama4": dict(arch="llama4_maverick_400b",
                           capacity_factor=None),
            "dbrx_drop": dict(arch="dbrx_132b", capacity_factor=0.5)}
EP_WORLDS = (2, 4)


def ep_layer(case: str):
    """(experts_per_token, capacity_factor) of an ``EP_CASES`` case."""
    from repro_torch.configs.base import get_config, smoke_variant
    c = EP_CASES[case]
    cfg = smoke_variant(get_config(c["arch"]))
    return cfg.experts_per_token, (c["capacity_factor"]
                                   or cfg.moe_capacity_factor)


def _ep_grads(inputs: dict, after_forward=None, **kw) -> dict:
    """y, aux and the gradients of sum(y * cot) + aux at ``inputs``;
    ``after_forward()`` runs between the forward and the backward."""
    import torch
    from repro_torch.models import mlp
    flat = {n[2:]: torch.tensor(v, requires_grad=True)
            for n, v in inputs.items() if n.startswith("p.")}
    params = {n: t for n, t in flat.items() if "." not in n}
    shared = {n[len("shared."):]: t for n, t in flat.items()
              if n.startswith("shared.")}
    if shared:
        params["shared"] = shared
    x = torch.tensor(inputs["x"], requires_grad=True)
    y, aux = mlp.moe_apply(params, x, mode="scatter", **kw)
    if after_forward is not None:
        after_forward()
    ((y * torch.tensor(inputs["cot"])).sum() + aux).backward()
    out = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
           "grad.x": x.grad.numpy()}
    out.update({f"grad.{n}": t.grad.numpy() for n, t in flat.items()})
    return out


def ep_probe(rank: int, world: int, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import mlp
    mesh = make_host_mesh(1, world, device="cpu")
    axis = mlp.expert_axis(mesh, "model")
    for case in EP_CASES:
        inputs = dict(np.load(os.path.join(out_dir, f"ep_{case}.npz")))
        k, cf = ep_layer(case)
        kw = dict(experts_per_token=k, capacity_factor=cf)
        axis.reset_counts()
        fwd = {}
        res = _ep_grads(inputs, mesh=mesh, model_axis="model",
                        after_forward=lambda: fwd.update(
                            calls=dict(axis.counts),
                            sent=dict(axis.sent_bytes)), **kw)
        res["counts"] = np.asarray(json.dumps({
            "fwd_calls": fwd["calls"], "fwd_sent": fwd["sent"],
            "bwd_calls": {n: c - fwd["calls"].get(n, 0)
                          for n, c in axis.counts.items()},
            "bwd_sent": {n: b - fwd["sent"].get(n, 0)
                         for n, b in axis.sent_bytes.items()}}))
        if rank == 0:
            res.update({f"single.{n}": v
                        for n, v in _ep_grads(inputs, **kw).items()})
        np.savez(os.path.join(out_dir, f"{world}_ep_{case}_{rank}.npz"),
                 **res)


def worlds_of(group: str) -> list:
    if group == "ep":
        return list(EP_WORLDS)
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
        if group == "ep":
            ep_probe(rank, world, out_dir)
        else:
            run_cases(rank, world, out_dir, group)
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    import torch.multiprocessing as mp
    out_dir, group = os.path.abspath(argv[0]), argv[1]
    # telemetry runs write no run registry
    os.environ["REPRO_RUNS_DIR"] = "off"
    for world in worlds_of(group):
        mp.spawn(_rank, args=(world, out_dir, group), nprocs=world)
    print("DIST_RANKS_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
