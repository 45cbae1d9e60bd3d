"""The verifier's batch metrics (`ops/verifier.py`): `verifier.batches`,
`verifier.sigs`, `verifier.batch_size` and `verifier.e2e_s`, recorded once
per non-empty call of `verify_batch_mask` and of
`verify_batch_mask_committee`, `e2e_s` around the whole call, the latch's
host-hash retry included, as the reference records them
(`hotstuff_tpu/ops/ed25519.py:983-988`, `:1146-1151`). The telemetry
plane's verify.e2e SLO reads `e2e_s`.

On the CPU, at a few lanes of the plain kernels: one generic batch whose
device hash is made to fail (so it runs twice inside one call) and one
committee batch.
"""

from __future__ import annotations

import random

from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.ops import ladder
from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_threads import one_torch_thread  # noqa: F401


def _batch(n: int, seed: int):
    rng = random.Random(seed)
    seeds = [rng.randbytes(32) for _ in range(n)]
    keys = [pysigner.keypair_from_seed(s)[0] for s in seeds]
    msgs = [rng.randbytes(32) for _ in range(n)]
    sigs = [pysigner.sign(s, m, public_key=k) for s, m, k in zip(seeds, msgs, keys)]
    sigs[1] = bytes(64)
    return msgs, keys, sigs


def _state() -> dict:
    d = metrics.dump(include_buckets=False)
    c, h = d["counters"], d["histograms"]
    return {"batches": c["verifier.batches"], "sigs": c["verifier.sigs"],
            "committee_batches": c["verifier.committee_batches"], "e2e": h["verifier.e2e_s"]["count"],
            "sizes": h["verifier.batch_size"]["count"], "size_sum": h["verifier.batch_size"]["sum"]}


def test_each_call_records_one_batch_and_one_e2e_sample(monkeypatch):
    v = Ed25519TorchVerifier(device="cpu", min_bucket=8, max_bucket=8)
    n1, n2 = 3, 5
    gmsgs, gkeys, gsigs = _batch(n1, 1)
    cmsgs, ckeys, csigs = _batch(n2, 2)
    before = _state()
    assert v.verify_batch_mask([], [], []).size == 0  # empty: nothing recorded
    assert _state() == before

    def fail(*_a, **_k):
        raise RuntimeError("injected device-hash failure")

    monkeypatch.setattr(ladder, "verify_packed128_dh", fail)
    assert v.verify_batch_mask(gmsgs, gkeys, gsigs).tolist() == [True, False, True]
    assert v.device_hash_fallbacks == 1  # two runs inside the one call
    monkeypatch.undo()
    v.set_committee(ckeys)
    assert v.verify_batch_mask_committee(cmsgs, list(range(n2)), csigs).tolist() == [True, False, True, True, True]
    after = _state()
    delta = {k: after[k] - before[k] for k in after}
    assert delta == {"batches": 2, "sigs": n1 + n2, "committee_batches": 1, "e2e": 2, "sizes": 2,
                     "size_sum": n1 + n2}
