"""Leader election (reference consensus/src/leader.rs:16-20).

`LeaderElector` — round-robin over the sorted authority keys — of the
committee governing the round, so rotation crosses epoch boundaries with
the committee (consensus/reconfig.py): a joined validator enters the
rotation at its epoch's activation round and a departed one leaves it.

The port's copy of `hotstuff_tpu/consensus/leader.py`, its imports
rewritten to this package. The reference's `RegionAwareElector`
(`Parameters.region_aware_election`) is not ported: it reads the
telemetry plane's region inference, and `Consensus.run` refuses it.
"""

from __future__ import annotations

from ..crypto import PublicKey
from .config import Committee
from .reconfig import Round, as_manager


class LeaderElector:
    def __init__(self, committee: Committee) -> None:
        # Committee or reconfig.EpochManager (per-epoch sorted keys are
        # cached inside the schedule — this resolves every round).
        self._epochs = as_manager(committee)

    def get_leader(self, round_: Round) -> PublicKey:
        keys = self._epochs.schedule.sorted_keys_for_round(round_)
        return keys[round_ % len(keys)]
