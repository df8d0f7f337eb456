"""Attack-harness smoke on the PyTorch port: the robustness story in a
few seconds (the twin of ``benchmarks/attack_smoke.py``).

A lasso over the 16-node torus (torus_2d(4, 4)), two nodes that send a
sign-flipped, 10x inflated payload from round 5 on (a seeded Byzantine
attack, wire-only: their own states stay honest). Three checks:

1. undefended: the honest-cohort certificate detects the attack
   (``violated_round`` is set);
2. ``robust="trim"``: the gate drops the lies, the run certifies the eps
   gap within 2x the clean run's round count and the certificate stays
   sound;
3. the trim-defended run through ``run_dist_cola(comm="plan")`` in a
   process group of one rank the script makes (NCCL on the card, gloo on
   the CPU, on a free localhost port): bitwise the ``run_cola`` state,
   no violation, the same stop round.

The local solves run through the port's CUDA CD kernels on the card
(``--device cuda``, the default) and their plain PyTorch version with
``--device cpu``. Prints ``ATTACK_SMOKE_OK`` on success; a failed check
raises.

  PYTHONPATH=src python examples/torch_attack_smoke.py [--device cpu]
"""
import argparse
import socket

import torch
import torch.distributed as dist

from repro_torch import PROBLEMS, ColaConfig, attack, run_cola
from repro_torch.core import topology as topo
from repro_torch.data import synthetic
from repro_torch.dist import run_dist_cola


def one_rank_group(device: str) -> None:
    """A process group of this process alone: NCCL on the card, gloo on
    the CPU, through a free localhost port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kw = {}
    if device != "cpu":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0, **kw)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the runs happen (default cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args()

    x, y, _ = synthetic.regression(48, 24, seed=0)
    prob = PROBLEMS["lasso"](x, y, 5e-2, box=5.0, device=args.device)
    graph = topo.torus_2d(4, 4)
    byz = attack.Byzantine(nodes=(0, 10), mode="sign_flip", scale=10.0,
                           start=5, seed=1)

    kw = dict(rounds=2000, record_every=20, recorder="gap+certificate",
              eps=1.0, device=args.device)

    def sim(robust, atk, result=False):
        res = run_cola(prob, graph, ColaConfig(kappa=2.0, robust=robust),
                       attacks=[atk] if atk else None, **kw)
        return res if result else res.history

    clean = sim(None, None)
    assert clean["stop_round"] is not None, \
        "clean run never certified the eps=1.0 gap"
    assert clean["violated_round"] is None

    undefended = sim(None, byz)
    assert undefended["violated_round"] is not None, \
        "undefended sign-flip attack went undetected by the certificate"
    print(f"attack_smoke,undefended,violated_round="
          f"{undefended['violated_round']}")

    trim_run = sim("trim", byz, result=True)
    trim = trim_run.history
    assert trim["violated_round"] is None, \
        "trim-defended run tripped the honest-cohort certificate"
    assert trim["stop_round"] is not None and \
        trim["stop_round"] <= 2 * clean["stop_round"], \
        "trim defense did not converge within 2x the clean round count"
    print(f"attack_smoke,trim,stop_round={trim['stop_round']} "
          f"(clean {clean['stop_round']})")

    # the defended run through the compiled plan over the ranks of a
    # group of one: bitwise the run_cola run
    one_rank_group(args.device)
    try:
        got = run_dist_cola(prob, graph, ColaConfig(kappa=2.0, robust="trim"),
                            None, comm="plan", attacks=[byz], **kw)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got.state.x_parts, trim_run.state.x_parts) and \
        torch.equal(got.state.v_stack, trim_run.state.v_stack), \
        "the defended plan run is not bitwise the run_cola run"
    assert got.history["violated_round"] is None
    assert got.history["stop_round"] == trim["stop_round"]
    print("attack_smoke,dist_plan,ranks=1,bitwise=ok")
    print("ATTACK_SMOKE_OK")


if __name__ == "__main__":
    main()
