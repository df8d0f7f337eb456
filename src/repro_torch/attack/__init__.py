"""repro_torch.attack — adversarial attack scenarios as schedule transforms.

A scenario rewrites or adds entries of the driver's materialized (T, ...)
schedule that the round body reads (``run_cola(attacks=...)``), composing
with churn and budget schedules, which are materialized first; the
generative ones also stream (``streamed_attacks``). Defenses live in the
mixing layer (``ColaConfig(robust=...)`` →
``repro_torch.core.mixing.robust_neighborhood_mix``); detection lives in
the certificate layer (the Lemma-1 consensus residual, audited over the
honest cohort by ``metrics.attackify``). Threat model: attacks corrupt the
data plane (payloads, links, work); the recorders are trusted telemetry.
"""
from repro_torch.attack.audit import gradient_inversion_report, \
    payload_cosines
from repro_torch.attack.scenarios import (ATTACK_ENTRY_NAMES, AttackContext,
                                          AttackInfo, Byzantine, Eavesdropper,
                                          FreeRider, LinkCorruption,
                                          SCENARIOS, apply_attacks,
                                          register_scenario, scenario,
                                          streamed_attacks)

__all__ = [
    "ATTACK_ENTRY_NAMES", "AttackContext", "AttackInfo", "Byzantine",
    "Eavesdropper", "FreeRider", "LinkCorruption", "SCENARIOS",
    "apply_attacks", "register_scenario", "scenario", "streamed_attacks",
    "gradient_inversion_report", "payload_cosines",
]
