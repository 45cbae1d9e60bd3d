"""Live safety/liveness invariant checking over honest commit streams.

The orchestrator feeds every honest node's commit channel through these
checkers DURING the run (not post-hoc), so a violation pinpoints the
first offending commit in the fault trace timeline.

Safety (2-chain HotStuff, consensus/src/messages.rs quorum rules):
  * agreement   — no two honest nodes commit different blocks at one round;
  * monotonic   — each node's committed rounds strictly increase (the
                  crash-restart double-commit guard);
  * chain-link  — consecutive commits certify their predecessor: a QC
                  round can never fall below the last committed round, and
                  a QC at that round must certify exactly that block
                  (fork detection);
  * certificates — every committed block's embedded QC re-verifies against
                  the pure-python RFC 8032 verifier with quorum stake:
                  zero false accepts can survive into a committed QC.
  * epochs      — the checker maintains its OWN committee schedule from
                  the committed chain (re-verifying each EpochChange's
                  authority + signature independently), and judges every
                  committed QC against the committee of the QC's round's
                  epoch — on BOTH sides of a reconfiguration boundary. A
                  certificate quorate under the wrong epoch's committee
                  is a violation even if every signature is genuine.
  * election    — the proposer of every committed block must be the
                  leader the checker derives INDEPENDENTLY for that
                  round from chain content alone: its own self-derived
                  committee schedule plus the run's frozen region map,
                  through the same pure rule the fleet's elector uses
                  (round-robin, or consensus/leader.elect_region_aware
                  when the run is region-aware, §5.5p). This pins that
                  region-aware schedules resolve bit-identically on
                  every node — a schedule split would surface as an
                  unelected proposer's block getting committed.
  * handoff     — the epoch-final contract, derived from chain content
                  alone: for every committed EpochChange, the carrier's
                  2-chain completion (a pair of consecutive-round
                  committed blocks at/above the carrier) must sit
                  strictly below the declared activation round. A chain
                  violating this has gap rounds certified by the old
                  committee — exactly what the certification wall
                  (consensus/reconfig.py §5.5j) exists to forbid, so
                  `reconfig.late_applies` is a violation here, not a
                  warning.

Liveness: commit height advances after a declared heal point (partitions
healed, crashed nodes restarted) — evaluated per honest node.
"""

from __future__ import annotations

from ..consensus.leader import elect_region_aware
from ..consensus.reconfig import EpochSchedule
from ..crypto import pysigner
from ..utils import metrics

_M_CHECKS = metrics.counter("chaos.invariant_checks")
_M_VIOLATIONS = metrics.counter("chaos.invariant_violations")


class SafetyChecker:
    def __init__(
        self,
        committee,
        region_of: dict | None = None,
        region_aware: bool = False,
    ) -> None:
        self.committee = committee
        # Independent epoch view derived from the committed chain itself —
        # never from any node's EpochManager state.
        self.schedule = EpochSchedule(committee)
        # Election audit inputs: the run's frozen region map (the same
        # seed-derived map the fleet elects by) and whether the fleet
        # runs the region-aware schedule. The DERIVATION stays the
        # checker's own: its self-built schedule, never a node's elector.
        self.region_of = dict(region_of or {})
        self.region_aware = bool(region_aware)
        self.violations: list[str] = []
        self._by_round: dict[int, tuple[bytes, int]] = {}  # round -> (digest, node)
        self._last: dict[int, object] = {}  # node -> last committed block
        self._verified_qcs: set[tuple[int, bytes]] = set()
        self.commits: dict[int, list[tuple[int, str]]] = {}  # node -> [(round, digest)]
        # Epoch-final handoff audits: one entry per committed EpochChange,
        # evaluated once the committed chain crosses its activation round.
        self._handoffs: list[dict] = []

    def _violate(self, msg: str) -> None:
        _M_VIOLATIONS.inc()
        self.violations.append(msg)

    def on_commit(self, node: int, block) -> None:
        _M_CHECKS.inc()
        digest = block.digest()
        self.commits.setdefault(node, []).append((block.round, str(digest)))

        seen = self._by_round.get(block.round)
        if seen is not None and seen[0] != digest.data:
            self._violate(
                f"conflicting commit at round {block.round}: node {node} "
                f"committed {digest.short()}, node {seen[1]} committed a "
                f"different block"
            )
        else:
            self._by_round[block.round] = (digest.data, node)

        prev = self._last.get(node)
        if prev is not None:
            if block.round <= prev.round:
                self._violate(
                    f"node {node} commit rounds not increasing: "
                    f"{prev.round} then {block.round}"
                )
            if block.qc.round < prev.round:
                self._violate(
                    f"node {node} committed B{block.round} whose QC round "
                    f"{block.qc.round} is below the previous commit "
                    f"{prev.round} (fork)"
                )
            elif block.qc.round == prev.round and block.qc.hash != prev.digest():
                self._violate(
                    f"node {node} committed B{block.round} certifying a "
                    f"different round-{prev.round} block than it committed"
                )
        self._last[node] = block
        self._check_leader(node, block)
        self._check_certificate(node, block)
        if getattr(block, "reconfig", None) is not None:
            self._check_reconfig(node, block)
        self._check_handoffs(block)

    def expected_leader(self, round_: int):
        """The round's leader derived from chain content alone: the
        checker's self-built schedule plus the frozen region map —
        the same pure function every honest elector computes
        (consensus/leader.py §5.5p)."""
        keys = self.schedule.sorted_keys_for_round(round_)
        if self.region_aware:
            return elect_region_aware(round_, keys, self.region_of)
        return keys[round_ % len(keys)]

    def _check_leader(self, node: int, block) -> None:
        """Election-schedule audit: a committed block authored by anyone
        but the independently derived leader of its round means either
        a forged proposal survived or honest nodes disagree on the
        schedule (the region-aware split hazard)."""
        author = getattr(block, "author", None)
        if author is None:
            return
        _M_CHECKS.inc()
        try:
            expected = self.expected_leader(block.round)
        except Exception:
            # A round outside the checker's derived schedule (stale
            # replay artifacts) is judged by the other invariants.
            return
        if author != expected:
            self._violate(
                f"election schedule violated: node {node} committed "
                f"B{block.round} authored by {author.short()}, expected "
                f"leader {expected.short()}"
            )

    def _check_certificate(self, node: int, block) -> None:
        """Re-verify the committed block's embedded QC with the independent
        exact-integer verifier: quorum stake AND every signature, judged
        against the committee of the QC's OWN epoch (the checker's
        self-derived schedule). A forged vote that slipped into an
        assembled QC — or a quorum counted under the wrong epoch's
        committee — is caught here."""
        qc = block.qc
        if qc.is_genesis():
            return
        key = (qc.round, qc.hash.data)
        if key in self._verified_qcs:
            return
        self._verified_qcs.add(key)
        _M_CHECKS.inc()
        committee = self.schedule.committee_for_round(qc.round)
        try:
            qc.check_quorum(committee)
        except Exception as e:
            self._violate(
                f"committed QC fails quorum check against epoch "
                f"{committee.epoch} at node {node}: {e}"
            )
            return
        msg = qc.signed_digest().data
        if not hasattr(qc, "votes"):
            # Aggregate form (messages.AggQC): no per-entry signatures to
            # re-check — the independent audit is a full re-verification
            # of the ONE aggregate signature against the bitmap members'
            # registered aggregate keys (byte-exact under the trusted-agg
            # stub, a pairing under exact BLS), preserving the
            # zero-false-accept contract for aggregate fleets.
            try:
                qc.verify(committee)
            except Exception as e:
                self._violate(
                    f"FALSE ACCEPT: committed aggregate QC (round {qc.round}) "
                    f"fails re-verification at node {node}: {e}"
                )
            return
        for pk, sig in qc.votes:
            if not pysigner.verify(pk.data, msg, sig.data):
                self._violate(
                    f"FALSE ACCEPT: committed QC (round {qc.round}) carries "
                    f"an invalid signature by {pk.short()}"
                )

    def _check_reconfig(self, node: int, block) -> None:
        """A committed EpochChange re-verifies independently (author holds
        stake in the CARRYING round's epoch, genuine signature, boundary
        past the carrying block) and then extends the checker's own
        schedule — the mapping later certificates are judged by."""
        change = block.reconfig
        _M_CHECKS.inc()
        committee = self.schedule.committee_for_round(block.round)
        if committee.stake(change.author) <= 0:
            self._violate(
                f"committed EpochChange (node {node}) signed by "
                f"{change.author.short()}, not an epoch-{committee.epoch} "
                "authority"
            )
            return
        if not pysigner.verify(
            change.author.data, change.digest().data, change.signature.data
        ):
            self._violate(
                f"FALSE ACCEPT: committed EpochChange (node {node}) carries "
                f"an invalid signature by {change.author.short()}"
            )
            return
        if change.activation_round <= block.round:
            self._violate(
                f"committed EpochChange activates at round "
                f"{change.activation_round}, not past its carrying block "
                f"B{block.round}"
            )
            return
        # Boundary = the DECLARED activation round, exactly as every
        # node's EpochManager schedules it (pure chain content — see
        # reconfig.EpochManager.apply for why no commit-position input
        # is folded in). Idempotent per epoch.
        if self.schedule.apply(change.activation_round, change.committee()):
            self._handoffs.append(
                {
                    "carrier": block.round,
                    "activation": change.activation_round,
                    "epoch": change.new_epoch,
                    "checked": False,
                }
            )

    def _check_handoffs(self, block) -> None:
        """The epoch-final handoff, re-derived from chain content alone:
        once the committed chain reaches a change's activation round, a
        pair of consecutive-round committed blocks (k, k+1) with
        carrier <= k and k+1 < activation must already exist — the pair
        whose second block's certificate made the carrier's commit
        determined BEFORE the boundary. Its absence means the handoff
        was completed by certificates formed at/after the boundary:
        gap rounds certified by the old committee (the late-apply
        pathology, now a hard violation)."""
        for h in self._handoffs:
            if h["checked"] or block.round < h["activation"]:
                continue
            h["checked"] = True
            _M_CHECKS.inc()
            complete = any(
                k in self._by_round and k + 1 in self._by_round
                for k in range(h["carrier"], h["activation"] - 1)
            )
            if not complete:
                self._violate(
                    f"epoch handoff violated: epoch {h['epoch']} carrier at "
                    f"round {h['carrier']} was not 2-chain-final before its "
                    f"activation round {h['activation']} — gap rounds were "
                    "certified by the old committee"
                )

    def ok(self) -> bool:
        return not self.violations


class LivenessChecker:
    """Records (node, round, virtual time) per commit; `require_progress`
    asserts each honest node's commit height advanced past `after_t`."""

    def __init__(self) -> None:
        self._timeline: dict[int, list[tuple[float, int]]] = {}
        self.violations: list[str] = []

    def on_commit(self, node: int, block, t: float) -> None:
        self._timeline.setdefault(node, []).append((t, block.round))

    def commit_times(self) -> dict[int, list[float]]:
        """Per-node commit instants (seconds on the run's clock), in
        commit order — the report's plateau/throughput-window evidence."""
        return {
            node: [t for t, _r in entries]
            for node, entries in self._timeline.items()
        }

    def max_round(self, node: int, up_to: float | None = None) -> int:
        rounds = [
            r
            for (t, r) in self._timeline.get(node, [])
            if up_to is None or t <= up_to
        ]
        return max(rounds, default=0)

    def require_commits(self, honest: list[int], minimum: int = 1) -> None:
        _M_CHECKS.inc()
        for node in honest:
            n = len(self._timeline.get(node, []))
            if n < minimum:
                _M_VIOLATIONS.inc()
                self.violations.append(
                    f"liveness: node {node} committed {n} blocks (< {minimum})"
                )

    def require_progress(self, after_t: float, honest: list[int]) -> None:
        """Every honest node's commit height must have advanced after the
        heal point (partition lifted / node restarted)."""
        _M_CHECKS.inc()
        for node in honest:
            before = self.max_round(node, up_to=after_t)
            after = self.max_round(node)
            if after <= before:
                _M_VIOLATIONS.inc()
                self.violations.append(
                    f"liveness: node {node} height stuck at {before} after "
                    f"heal t={after_t}"
                )

    def ok(self) -> bool:
        return not self.violations
