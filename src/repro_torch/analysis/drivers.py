"""Registered driver configurations for the contract analysis.

Every entry in ``DRIVER_REGISTRY`` is a zero-argument check that builds
one of the port's COLA programs at the reference's small shapes
(``_lasso``, ``_ridge``) and holds it to its contracts, the twins of the
reference's ``repro.analysis.drivers``:

* **the simulator drivers** (``sim``, ``sim-robust``, ``gossip-dp``,
  ``executor-retrace``) run ``passes``' trace passes over one block of the
  round-block executor (``run_cola``'s block of ``cola._round_body``, the
  gossip optimizer's in-place DP mix), or its retrace check; ``sim`` also
  holds its telemetry twin to ``telemetry-carry``;
* **the dist drivers** (``dist-*``, ``cert-*``, ``gap-record``) run one
  round body or one record of the distributed runtime on real ranks and
  hold the collective calls and bytes its ``NodeAxis`` counted to the
  contract the reference's driver builds: the plan's ``contract()``, or
  ``ring_contract`` / ``certificate_contract`` / ``gather_contract``.

The settings (``settings``) give the device (default ``"cuda"``) and the
process group: the dist drivers need as many ranks as the reference's
need devices (4; ``dist-block`` 3, a subgroup of a larger group) and raise
``SkipDriver`` with the reason when the group is smaller, as
``_require_devices`` does. ``python -m repro_torch.analysis --ranks 4``
spawns the ranks once for all of them (``rank_worker``).
"""
from __future__ import annotations

import contextlib
import datetime
import json
import os
import traceback
from typing import Callable, List

import numpy as np
import torch

from repro_torch.analysis import contracts, passes
from repro_torch.analysis.passes import Finding

DRIVER_REGISTRY: dict = {}


class SkipDriver(RuntimeError):
    """Raised by a driver check whose rank requirements this process
    cannot satisfy (too few ranks)."""


class NotMember(RuntimeError):
    """This rank is outside the subgroup a driver runs on."""


def register_driver(name: str, *, ranks: int = 0) -> Callable:
    """Register a driver; ``ranks``: the ranks it runs on (0: none)."""
    def deco(fn):
        DRIVER_REGISTRY[name] = fn
        fn.driver_name = name
        fn.ranks = ranks
        return fn
    return deco


# -- settings ---------------------------------------------------------------

_SETTINGS = {"device": None, "axis": None, "subgroups": {}}


@contextlib.contextmanager
def settings(device=None, axis=None, subgroups=None):
    """Run the drivers in the scope on ``device`` (default "cuda") over
    ``axis`` (a ``NodeAxis`` of the group, or None) and its
    ``subgroups`` ({ranks: NodeAxis, or None on a rank outside it})."""
    old = dict(_SETTINGS)
    _SETTINGS.update(device=device, axis=axis, subgroups=subgroups or {})
    try:
        yield
    finally:
        _SETTINGS.update(old)


def _device() -> torch.device:
    from repro_torch.device import resolve
    return resolve(_SETTINGS["device"])


def _require_ranks(n: int):
    """The ``NodeAxis`` of exactly ``n`` ranks, or ``SkipDriver``."""
    axis = _SETTINGS["axis"]
    have = 0 if axis is None else axis.size
    if have < n:
        raise SkipDriver(
            f"needs {n} ranks, the group has {have} (run via `python -m "
            f"repro_torch.analysis --device cpu --ranks 4`)")
    if have == n:
        return axis
    if n not in _SETTINGS["subgroups"]:
        raise SkipDriver(f"needs a subgroup of {n} of the group's {have} "
                         "ranks")
    sub = _SETTINGS["subgroups"][n]
    if sub is None:
        raise NotMember(f"outside the {n}-rank subgroup")
    return sub


def subgroup_sizes(world: int) -> list:
    """The subgroup sizes the registered drivers and selftests need in a
    group of ``world`` ranks (every rank creates them, in this order)."""
    from repro_torch.analysis import selftest
    fns = list(DRIVER_REGISTRY.values()) + list(selftest.SELFTESTS.values())
    return sorted({fn.ranks for fn in fns
                   if 1 < getattr(fn, "ranks", 0) < world})


def _problem(kind: str, n_samples: int, d: int):
    from repro_torch.core import problems
    from repro_torch.data import synthetic
    if kind == "lasso":
        x, y, _ = synthetic.regression(n_samples, d, seed=2,
                                       sparsity_solution=0.2)
        return problems.lasso(x, y, 5e-2, box=5.0, device=_device())
    x, y, _ = synthetic.regression(n_samples, d, seed=0)
    return problems.ridge_primal(x, y, 1e-2, device=_device())


def _lasso(n_samples: int = 150, d: int = 48):
    return _problem("lasso", n_samples, d)


def _ridge(n_samples: int = 64, d: int = 32):
    return _problem("ridge", n_samples, d)


def _check_comm_to_findings(check: Callable[[], dict],
                            name: str) -> List[Finding]:
    try:
        check()
    except contracts.CommContractViolation as e:
        return [Finding("comm-contract", str(e), where=name)]
    return []


# -- one round or one record over ranks -------------------------------------

def dist_round(prob, graph, cfg, axis, *, comm: str, conn: int = 1,
               inject: Callable | None = None):
    """One round of the distributed runtime's body on this rank's block
    (``runtime.dist_round_body``, the body ``run_dist_cola`` runs): the
    collective report of that round alone (``op_analysis.axis_report``),
    the plan, the state the round started from and the state it left.
    ``inject(axis, state, new)``: a seeded violation run after the body,
    counted with the round."""
    from repro_torch.core import cola, quant, topology as topo
    from repro_torch.core.partition import make_partition
    from repro_torch.dist import runtime, sharding
    from repro_torch.launch import op_analysis
    from repro_torch.topo import plan as tplan
    dev = _device()
    k = graph.num_nodes
    part = make_partition(prob.n, k)
    w = topo.metropolis_weights(graph).astype(np.float32)
    body, comm, plan = runtime.dist_round_body(prob, part, cfg, axis, graph,
                                               w, comm=comm, conn=conn)
    env = sharding.cola_env_block(
        prob, part, axis, with_gram=cfg.use_gram(prob.d, part.block,
                                                 prob.a.element_size()))
    sched = {"w": w[None], "active": np.ones((1, k), np.float32)}
    if plan is not None:
        cls = (tplan.BlockPlanSchedule if isinstance(plan, tplan.BlockPlan)
               else tplan.PlanSchedule)
        sched.update(cls.from_w_stack(plan, sched.pop("w"),
                                      static=True).entries())
    s_t = {name: torch.as_tensor(np.array(v[0]), device=dev)
           for name, v in sharding.schedule_block(sched, axis).items()}
    payload = (s_t["w"] if plan is None else s_t["plan_w"]
               if "plan_w" in s_t else (s_t["plan_diag"], s_t["plan_coefs"]))
    state = sharding.cola_state_block(cola.init_state(prob, part), axis)
    gen = torch.Generator().manual_seed(axis.index)
    state = state._replace(
        v_stack=torch.randn(state.v_stack.shape, generator=gen).to(dev))
    wire_kw = {}
    if quant.is_quantized(cfg.wire):
        draws = quant.wire_uniforms(0, k, prob.d, dev,
                                    rows=sharding.node_rows(axis, k))
        state = cola._arm_wire_state(state, cfg, draws)
        wire_kw = cola._round_draws(draws, 0)
    axis.warm_up(dev)
    since = (dict(axis.counts), dict(axis.sent_bytes))
    new = body(state, env, payload, s_t["active"], None, **wire_kw)
    if inject is not None:
        inject(axis, state, new)
    return op_analysis.axis_report(axis, since), plan, state, new


def dist_record(prob, graph, axis, recorder: str, *, comm: str,
                conn: int = 1):
    """One record of ``recorder`` ("certificate" or "gap") on this rank's
    block, through the distributed runtime's record program: its
    collective report."""
    from repro_torch.core import cola, metrics, topology as topo
    from repro_torch.core.partition import make_partition
    from repro_torch.dist import runtime, sharding
    from repro_torch.launch import op_analysis
    from repro_torch.topo import plan as tplan
    dev = _device()
    k = graph.num_nodes
    part = make_partition(prob.n, k)
    if recorder == "certificate":
        rec = metrics.make_recorder("certificate", prob, part,
                                    cola.build_env(prob, part), graph,
                                    topo.metropolis_weights(graph), 0.1)
    else:
        rec = metrics.GapRecorder(prob, part)
    plan = tplan.compile_plan(graph) if comm == "plan" else None
    record = runtime._dist_record_fn(rec, axis, k // axis.size, comm, conn,
                                     sharding.cola_env_block(prob, part,
                                                             axis), plan)
    state = sharding.cola_state_block(cola.init_state(prob, part), axis)
    gen = torch.Generator().manual_seed(axis.index)
    state = state._replace(
        v_stack=torch.randn(state.v_stack.shape, generator=gen).to(dev))
    axis.warm_up(dev)
    since = (dict(axis.counts), dict(axis.sent_bytes))
    record(state)
    return op_analysis.axis_report(axis, since)


@contextlib.contextmanager
def first_permutes(axis):
    """Record the tensors ``axis.permute`` is called with, in order."""
    sent: list = []
    inner = axis.permute

    def permute(x, pairs):
        sent.append(x)
        return inner(x, pairs)

    axis.permute = permute
    try:
        yield sent
    finally:
        del axis.permute


def pipeline_order_findings(sent: list, carried, where: str
                            ) -> List[Finding]:
    """The pipelined round's first exchange sends the CARRIED double
    buffer — the payload encoded at the end of the previous round, a
    tensor that existed when the round began — not one encoded from this
    round's v, which would wait on the encode instead of overlapping the
    solve. ``sent``: the tensors ``axis.permute`` sent (``first_permutes``);
    ``carried``: the state's ``buf`` at the start of the round."""
    if not sent:
        return [Finding("pipeline-order",
                        "no exchange ran — the round body lost its neighbor "
                        "exchange", where=where)]
    buf = {t.untyped_storage().data_ptr()
           for t in (carried or ()) if isinstance(t, torch.Tensor)}
    if sent[0].untyped_storage().data_ptr() in buf:
        return []
    return [Finding(
        "pipeline-order",
        "first exchange sends a payload encoded in this round (its storage "
        "is not the carried buffer's) — the double-buffered payload is not "
        "overlapping the solve", where=where)]


# -- the simulator round block ----------------------------------------------

@contextlib.contextmanager
def _no_registry():
    """Telemetry runs write no run registry."""
    from repro_torch.obs import report
    old = os.environ.get(report.ENV_DIR)
    os.environ[report.ENV_DIR] = "off"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(report.ENV_DIR, None)
        else:
            os.environ[report.ENV_DIR] = old


def _sim_run(cfg, rounds: int = 4, block_size: int | None = None,
             record_every: int = 1) -> Callable:
    """``run_cola`` at the reference's sim shape: ridge (64 x 32) over
    ring(8), gap recorder, one block of ``rounds`` rounds."""
    from repro_torch.core import topology as topo
    from repro_torch.core.cola import run_cola
    prob = _ridge()
    graph = topo.ring(8)
    return lambda: run_cola(prob, graph, cfg, rounds,
                            record_every=record_every, executor="block",
                            block_size=block_size or rounds,
                            device=_device())


def _check_sim(cfg, name: str) -> List[Finding]:
    run = _sim_run(cfg)
    run()
    return passes.trace_passes(passes.trace_ops(run), where=name)


@register_driver("sim")
def check_sim() -> List[Finding]:
    import dataclasses
    from repro_torch.core.cola import ColaConfig
    cfg = ColaConfig(kappa=1.0)
    findings = _check_sim(cfg, "sim")
    with _no_registry():
        on = passes.trace_ops(_sim_run(dataclasses.replace(cfg,
                                                           telemetry=True)))
    return findings + passes.telemetry_carry(
        passes.trace_ops(_sim_run(cfg)), on, where="sim")


@register_driver("sim-robust")
def check_sim_robust() -> List[Finding]:
    from repro_torch.core.cola import ColaConfig
    return _check_sim(ColaConfig(kappa=1.0, robust="trim"), "sim-robust")


@register_driver("gossip-dp")
def check_gossip_dp() -> List[Finding]:
    """Four rounds of the DP gossip mix on the executor: an in-place body
    over the (K, ...) parameter stacks."""
    from repro_torch.core import topology as topo
    from repro_torch.optim import gossip as gossip_lib
    from repro_torch.optim.privacy import DPConfig
    dev = _device()
    k = 8
    gcfg = gossip_lib.GossipConfig(num_nodes=k)
    mixer = gossip_lib._param_mixer(gcfg, None, None, None,
                                    DPConfig(clip=1.0, sigma=1.0))
    w = torch.as_tensor(topo.metropolis_weights(gcfg.graph()),
                        dtype=torch.float32, device=dev)
    params = {"w": torch.zeros((k, 16), device=dev),
              "b": torch.zeros((k,), device=dev)}
    program = passes.BlockProgram(
        step_fn=lambda p, _ctx, s_t, _stopped: mixer(
            w, p, dp_round=int(s_t["round"])),
        state=params, schedule={"round": np.arange(4)}, num_rounds=4,
        in_place=True, host_entries=("round",))
    return passes.run_block_passes(program, where="gossip-dp")


@register_driver("executor-retrace")
def check_executor_retrace() -> List[Finding]:
    """A repeated identical run reports one bypass per block-executor call
    and nothing else, and builds or loads no kernel."""
    from repro_torch.core.cola import ColaConfig
    return passes.check_retrace(
        _sim_run(ColaConfig(kappa=1.0), rounds=4, block_size=2,
                 record_every=2), where="executor-retrace")


# -- the dist drivers -------------------------------------------------------

def _dist_plan(graph, k: int, name: str, **cfg_kw) -> List[Finding]:
    from repro_torch.core.cola import ColaConfig
    prob = _lasso()
    report, plan, _, _ = dist_round(prob, graph, ColaConfig(kappa=1.0,
                                                            **cfg_kw),
                                    _require_ranks(k), comm="plan")
    return _check_comm_to_findings(
        lambda: contracts.check_comm(report, plan.contract(prob.d)), name)


@register_driver("dist-ring", ranks=4)
def check_dist_ring() -> List[Finding]:
    from repro_torch.core import topology as topo
    from repro_torch.core.cola import ColaConfig
    k, conn = 4, 1
    axis = _require_ranks(k)
    prob = _ridge()
    report, _, _, _ = dist_round(prob, topo.ring(k), ColaConfig(kappa=1.0),
                                 axis, comm="ring", conn=conn)
    return _check_comm_to_findings(
        lambda: contracts.check_comm(
            report, contracts.ring_contract(prob.d, conn)), "dist-ring")


@register_driver("dist-plan", ranks=4)
def check_dist_plan() -> List[Finding]:
    from repro_torch.core import topology as topo
    return _dist_plan(topo.torus_2d(2, 2), 4, "dist-plan")


@register_driver("dist-plan-sampled", ranks=4)
def check_dist_plan_sampled() -> List[Finding]:
    """Client sampling on the compiled per-node plan: the complete-graph
    round honors the full plan's contract, and every sampled cohort's
    churn-reweighted W runs on that SAME static plan — its (diag, coefs)
    lowering round-trips through ``w_from_coefficients`` exactly (sampling
    only zeroes edges, never grows the support)."""
    from repro_torch.core import schedule as schedule_lib, topology as topo
    from repro_torch.topo import plan as tplan
    k = 4
    graph = topo.complete(k)
    findings = _dist_plan(graph, k, "dist-plan-sampled")
    plan = tplan.compile_plan(graph)
    sample = schedule_lib.SampleConfig(k_active=2, mode="dense")
    mask_fn = schedule_lib.participation_callable(k, sample, run_seed=0)
    rng = np.random.default_rng(0)
    for t in range(8):
        mask = mask_fn(t, rng)
        w_t = np.asarray(topo.reweight_for_active(graph, mask))
        try:
            diag, coefs = tplan.plan_coefficients(plan, w_t, check=True)
        except ValueError as e:
            findings.append(Finding(
                "comm-contract",
                f"round {t} sampled mask {mask.astype(int).tolist()} "
                f"reweights outside the compiled complete-graph plan: {e}",
                where="dist-plan-sampled"))
            continue
        if not (tplan.w_from_coefficients(plan, diag, coefs) == w_t).all():
            findings.append(Finding(
                "comm-contract",
                f"round {t} (diag, coefs) lowering does not round-trip to "
                "the sampled W — the plan would execute a different matrix "
                "than the certificate accounts for",
                where="dist-plan-sampled"))
    return findings


@register_driver("dist-dense", ranks=4)
def check_dist_dense() -> List[Finding]:
    from repro_torch.core import topology as topo
    from repro_torch.core.cola import ColaConfig
    prob = _lasso()
    k, itemsize = 4, 4
    report, _, _, _ = dist_round(prob, topo.torus_2d(2, k // 2),
                                 ColaConfig(kappa=1.0), _require_ranks(k),
                                 comm="dense")
    return _check_comm_to_findings(
        lambda: contracts.check_comm(report, contracts.gather_contract(
            "dense-oracle", min_all_gather_bytes=prob.d * itemsize)),
        "dist-dense")


@register_driver("dist-block", ranks=3)
def check_dist_block() -> List[Finding]:
    from repro_torch.core import topology as topo
    from repro_torch.core.cola import ColaConfig
    prob = _lasso(153, 48)
    report, plan, _, _ = dist_round(prob, topo.complete(9),
                                    ColaConfig(kappa=1.0), _require_ranks(3),
                                    comm="plan")
    return _check_comm_to_findings(
        lambda: contracts.check_comm(report, plan.contract(prob.d)),
        "dist-block")


@register_driver("dist-block-robust", ranks=4)
def check_dist_block_robust() -> List[Finding]:
    from repro_torch.core import topology as topo
    return _dist_plan(topo.torus_2d(2, 4), 4, "dist-block-robust",
                      robust="trim")


def _dist_wire(wire: str, name: str, *, pipeline: bool = False,
               inject: Callable | None = None):
    """One round of the (K=8 over 4 ranks) block program on a quantized
    wire, with the permutes it sent: (findings of the wire contract,
    contract, sent tensors, the carried buffer)."""
    from repro_torch.core import topology as topo
    from repro_torch.core.cola import ColaConfig
    prob = _lasso()
    axis = _require_ranks(4)
    cfg = ColaConfig(kappa=1.0, wire=wire, pipeline=pipeline)
    with first_permutes(axis) as sent:
        report, plan, state, _ = dist_round(prob, topo.torus_2d(2, 4), cfg,
                                            axis, comm="plan", inject=inject)
    contract = plan.contract(prob.d, wire=wire)
    fp32_cap = plan.contract(prob.d).max_collective_permute_bytes
    findings = _check_comm_to_findings(
        lambda: contracts.check_comm(report, contract), name)
    return findings, contract, fp32_cap, sent, state.buf


@register_driver("dist-plan-int8", ranks=4)
def check_dist_plan_int8() -> List[Finding]:
    """The quantized wire's headline contract: the int8 round (what
    ``run_dist_cola(comm="plan", wire="int8")`` runs) moves at most the
    narrow wire's budget — itself at most 0.3x the fp32 budget — and
    gathers nothing."""
    findings, contract, fp32_cap, _, _ = _dist_wire("int8", "dist-plan-int8")
    if contract.max_collective_permute_bytes > 0.3 * fp32_cap:
        findings.append(Finding(
            "comm-contract",
            f"int8 wire budget {contract.max_collective_permute_bytes:,.0f}"
            f" B/device exceeds 0.3x the fp32 budget {fp32_cap:,.0f} — the"
            " codec is not actually narrowing the wire",
            where="dist-plan-int8"))
    return findings


@register_driver("dist-plan-fp8-pipelined", ranks=4)
def check_dist_plan_fp8_pipelined() -> List[Finding]:
    """The double-buffered fp8 round: the narrow wire's contract, and its
    first exchange sends the carried payload (``pipeline_order_findings``),
    the eager form of 'the exchange overlaps the CD solve'."""
    findings, _, _, sent, buf = _dist_wire("fp8", "dist-plan-fp8-pipelined",
                                           pipeline=True)
    return findings + pipeline_order_findings(sent, buf,
                                              "dist-plan-fp8-pipelined")


@register_driver("cert-ring", ranks=4)
def check_cert_ring() -> List[Finding]:
    from repro_torch.core import topology as topo
    prob = _lasso()
    k, conn = 4, 1
    report = dist_record(prob, topo.ring(k), _require_ranks(k),
                         "certificate", comm="ring", conn=conn)
    return _check_comm_to_findings(
        lambda: contracts.check_comm(
            report, contracts.certificate_contract(prob.d, conn)),
        "cert-ring")


@register_driver("cert-plan", ranks=4)
def check_cert_plan() -> List[Finding]:
    from repro_torch.core import topology as topo
    from repro_torch.topo import plan as tplan
    prob = _lasso()
    k, itemsize = 4, 4
    graph = topo.torus_2d(2, k // 2)
    report = dist_record(prob, graph, _require_ranks(k), "certificate",
                         comm="plan")
    # the reference's plan-path certificate budget: one (d,) exchange per
    # color and the O(d) psum
    plan = tplan.compile_plan(graph)
    contract = contracts.CommContract(
        name=f"certificate-plan-c{plan.num_colors}-d{prob.d}",
        forbid=("all-gather", "reduce-scatter", "all-to-all"),
        max_collective_permute_bytes=plan.num_colors * prob.d * itemsize,
        max_all_reduce_bytes=(4 * prob.d + 64) * itemsize)
    return _check_comm_to_findings(
        lambda: contracts.check_comm(report, contract), "cert-plan")


@register_driver("gap-record", ranks=4)
def check_gap_record() -> List[Finding]:
    from repro_torch.core import topology as topo
    prob = _lasso()
    k, itemsize = 4, 4
    report = dist_record(prob, topo.ring(k), _require_ranks(k), "gap",
                         comm="dense")
    return _check_comm_to_findings(
        lambda: contracts.check_comm(report, contracts.gather_contract(
            "gap-recorder", min_total_bytes=k * prob.d * itemsize)),
        "gap-record")


# -- running them -----------------------------------------------------------

def run_one(fn) -> dict:
    """Run one driver or selftest: ``{"status": "findings" | "skip" |
    "n/a" | "crash", "findings": [str], "detail": str}``."""
    try:
        found = fn()
    except SkipDriver as e:
        return {"status": "skip", "findings": [], "detail": str(e)}
    except NotMember as e:
        return {"status": "n/a", "findings": [], "detail": str(e)}
    except Exception:
        return {"status": "crash", "findings": [],
                "detail": traceback.format_exc()}
    return {"status": "findings", "findings": [str(f) for f in found],
            "detail": ""}


def merge_ranks(rows: list) -> dict:
    """One result from every rank's result of a driver: a crash on any
    rank is a crash; the findings of every member rank, once each."""
    crashed = [r for r in rows if r["status"] == "crash"]
    if crashed:
        return crashed[0]
    ran = [r for r in rows if r["status"] == "findings"]
    if not ran:
        skips = [r for r in rows if r["status"] == "skip"]
        return skips[0] if skips else rows[0]
    found = []
    for r in ran:
        found += [f for f in r["findings"] if f not in found]
    return {"status": "findings", "findings": found, "detail": ""}


def rank_worker(rank: int, world: int, out_dir: str, device: str,
                drivers: list, selftests: list) -> None:
    """One rank of ``python -m repro_torch.analysis --ranks M``: runs the
    named drivers and selftests over the group (a gloo group on the CPU,
    NCCL with one card per rank on CUDA; a collective that waits 120 s
    raises, so a hang fails instead of waiting) and writes its results to
    ``out_dir/rank<r>.json``."""
    import torch.distributed as dist
    from repro_torch.analysis import selftest
    from repro_torch.dist.axis import NodeAxis
    torch.set_num_threads(1)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    timeout = datetime.timedelta(seconds=120)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{out_dir}/store",
                            world_size=world, rank=rank, timeout=timeout)
    results = {}
    try:
        subgroups = {}
        for n in subgroup_sizes(world):
            group = dist.new_group(list(range(n)), timeout=timeout)
            subgroups[n] = NodeAxis(group) if rank < n else None
        with settings(device=device, axis=NodeAxis(), subgroups=subgroups):
            for name in drivers:
                results["driver:" + name] = run_one(DRIVER_REGISTRY[name])
            for name in selftests:
                results["selftest:" + name] = run_one(
                    selftest.SELFTESTS[name])
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
        dist.destroy_process_group()
