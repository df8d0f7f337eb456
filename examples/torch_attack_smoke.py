"""Attack-harness smoke on the PyTorch port: the robustness story in a
few seconds (the simulator half of ``benchmarks/attack_smoke.py``).

A lasso over the 16-node torus (torus_2d(4, 4)), two nodes that send a
sign-flipped, 10x inflated payload from round 5 on (a seeded Byzantine
attack, wire-only: their own states stay honest). Two checks:

1. undefended: the honest-cohort certificate detects the attack
   (``violated_round`` is set);
2. ``robust="trim"``: the gate drops the lies, the run certifies the eps
   gap within 2x the clean run's round count and the certificate stays
   sound.

The reference's third check, the distributed plan executor against the
simulator, waits for the port's ``run_dist_cola`` (ROADMAP queue 1 item
14). The local solves run through the port's CUDA CD kernels on the card
(``--device cuda``, the default) and their plain PyTorch version with
``--device cpu``. Prints ``ATTACK_SMOKE_OK`` on success; a failed check
raises.

  PYTHONPATH=src python examples/torch_attack_smoke.py [--device cpu]
"""
import argparse

from repro_torch import PROBLEMS, ColaConfig, attack, run_cola
from repro_torch.core import topology as topo
from repro_torch.data import synthetic


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

    def sim(robust, atk):
        return run_cola(prob, graph, ColaConfig(kappa=2.0, robust=robust),
                        rounds=2000, record_every=20,
                        recorder="gap+certificate", eps=1.0,
                        attacks=[atk] if atk else None,
                        device=args.device).history

    clean = sim(None, None)
    assert clean["stop_round"] is not None, \
        "clean run never certified the eps=1.0 gap"
    assert clean["violated_round"] is None

    undefended = sim(None, byz)
    assert undefended["violated_round"] is not None, \
        "undefended sign-flip attack went undetected by the certificate"
    print(f"attack_smoke,undefended,violated_round="
          f"{undefended['violated_round']}")

    trim = sim("trim", byz)
    assert trim["violated_round"] is None, \
        "trim-defended run tripped the honest-cohort certificate"
    assert trim["stop_round"] is not None and \
        trim["stop_round"] <= 2 * clean["stop_round"], \
        "trim defense did not converge within 2x the clean round count"
    print(f"attack_smoke,trim,stop_round={trim['stop_round']} "
          f"(clean {clean['stop_round']})")
    print("ATTACK_SMOKE_OK")


if __name__ == "__main__":
    main()
