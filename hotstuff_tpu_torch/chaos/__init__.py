"""Deterministic chaos subsystem: fault injection, Byzantine adversaries,
and live invariant checking against the real in-process consensus stack.

The port's copy of `hotstuff_tpu/chaos/`. It runs on the host, as the
reference's does: `ChaosOrchestrator.run` installs
`crypto.pysigner.PurePythonBackend` as the process's backend
(`hotstuff_tpu/chaos/orchestrator.py:1082`), every verification service
dispatches inline on the virtual-time loop, and device occupancy is only
modelled (`SchedulerConfig.pace_s_per_sig`). It is not a fallback of the
card's path: it never reaches a kernel, and no node process runs it.

Entry points:
  * `run_scenario(name, seed)` — execute one named scenario from
    `SCENARIOS` on a virtual-time loop; same seed => bit-identical fault
    trace and honest commit sequence.
  * `scenarios.run_matrix_cell(scenario, seed, n)` — one cell of the
    scenario matrix (`MATRIX_SCENARIOS` x `MATRIX_SEEDS` x
    `MATRIX_SIZES`), distilled by `utils/telemetry.fleet_rollup`.
  * `python -m hotstuff_tpu_torch.chaos_run` — the CLI wrapper
    (`--scenario`, `--seed`, `--report out.json`; `--matrix` sweeps the
    grid into one `chaos_matrix` artifact).

Layering: plan.py (declarative fault schedules + seeded RNG streams +
the WanMatrix per-region RTT classes) → transport.py (FaultyTransport
at the NetSender/NetReceiver seam) → byzantine.py (adversary policies)
→ invariants.py (safety/liveness checkers) → orchestrator.py (node
lifecycle, crash/restart) → scenarios.py (the library and the scenario
matrix's grid). vtime.py supplies the deterministic clock;
trusted_crypto.py supplies the keyed-hash stub scheme that makes
hundred-node fleets runnable on one box (see its trust model).
"""

from .byzantine import (
    AdversaryPolicy,
    BundlePoisoner,
    Equivocator,
    SigForger,
    StaleReplayer,
    VoteWithholder,
)
from .invariants import LivenessChecker, SafetyChecker
from .orchestrator import (
    BoundaryCrash,
    ChaosOrchestrator,
    DeterministicMempool,
    ReconfigDirective,
)
from .plan import (
    CrashWindow,
    DelayedBoot,
    FaultPlan,
    LinkFaults,
    Partition,
    SeededRng,
    WanMatrix,
)
from .scenarios import (
    MATRIX_SCENARIOS,
    MATRIX_SEEDS,
    MATRIX_SIZES,
    SCENARIOS,
    SHORT_SCENARIOS,
    run_scenario,
)
from .transport import FaultyTransport, NODE_LABEL
from .trusted_crypto import TrustedCryptoScheme
from .vtime import VirtualTimeLoop

__all__ = [
    "AdversaryPolicy",
    "BundlePoisoner",
    "BoundaryCrash",
    "ChaosOrchestrator",
    "CrashWindow",
    "DelayedBoot",
    "DeterministicMempool",
    "Equivocator",
    "FaultPlan",
    "FaultyTransport",
    "LinkFaults",
    "LivenessChecker",
    "MATRIX_SCENARIOS",
    "MATRIX_SEEDS",
    "MATRIX_SIZES",
    "NODE_LABEL",
    "Partition",
    "ReconfigDirective",
    "SCENARIOS",
    "SHORT_SCENARIOS",
    "SafetyChecker",
    "SeededRng",
    "SigForger",
    "StaleReplayer",
    "TrustedCryptoScheme",
    "VirtualTimeLoop",
    "VoteWithholder",
    "WanMatrix",
    "run_scenario",
]
