"""A whole run of a cell on the CPU at a tiny size, with the look for a
card skipped: sound, it comes out correct; with the timed path broken
underneath in each of the ways a COLA cell can be, it does not.

* ``unchanged``: a round returns its state unchanged;
* ``half_nodes``: half of the nodes' local solves are left out and the
  rest count double (the mean over the rest);
* ``no_exchange``: the gossip exchange is left out (no mix through W);
* ``altered``: the answer is altered where it is produced (one
  coordinate of x moved by a hundredth of |x|).
"""
from __future__ import annotations

import pytest
import torch

import repro_torch
from repro_torch.core import cola, mixing
from colabench import harness, registry

CELLS = [w["name"] for w in registry.bench_spec()["workloads"]]


def unchanged(mp):
    mp.setattr(cola, "_round_body",
               lambda *a, **k: (lambda state, *b, **c: state))


def half_nodes(mp):
    solve = cola.cd_solve_all

    def broken(*a, **k):
        dx = solve(*a, **k)
        half = dx.shape[0] // 2
        return torch.cat([2 * dx[:half], torch.zeros_like(dx[half:])])

    mp.setattr(cola, "cd_solve_all", broken)


def no_exchange(mp):
    mp.setattr(mixing, "mix_power_wire", lambda w, v_send, *a, **k: v_send)


def altered(mp):
    run = repro_torch.run_cola

    def broken(*a, **k):
        res = run(*a, **k)
        x = res.state.x_parts.clone()
        x.view(-1)[0] += 0.01 * torch.linalg.vector_norm(x)
        return res._replace(state=res.state._replace(x_parts=x))

    mp.setattr(repro_torch, "run_cola", broken)


FAULTS = {"unchanged": unchanged, "half_nodes": half_nodes,
          "no_exchange": no_exchange, "altered": altered}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_root, name):
    result = harness.run(name, 2 ** 31 + 13, 0.2, False, root=tiny_root,
                         device="cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"solve_s", "setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(tiny_root, monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    result = harness.run(name, 2 ** 31 + 13, 0.2, False, root=tiny_root,
                         device="cpu")
    assert not result["correct"], result["checks"]
