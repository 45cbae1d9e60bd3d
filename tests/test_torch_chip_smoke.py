"""CPU rehearsal of `chip_smoke.py`'s kernel-comparison phases.

On the CPU every kernel wrapper runs its plain version, so both sides of
each comparison are plain: these tests hold the phases' control flow
(shapes, widths, cuts, out-of-range indices, result rows), not the CUDA
kernels, which only `chip_smoke.py` on the card can hold. `LANES` is shrunk
to 16, which cuts the width list to 1, 7 and 16 and still holds the eight
special keys of K3 and the four out-of-range indices of K5, and the CUDA
timers are stubbed.
"""

from __future__ import annotations

import hashlib
import json
import re

import pytest

import chip_smoke
from hotstuff_tpu_torch import breakdown
from hotstuff_tpu_torch.crypto import pysigner
from tests.common_torch_threads import one_torch_thread  # noqa: F401

LANES = 16
KEYS = ("ladder", "h_digits", "decompress_table", "compress_eq")
ROW_KEYS = {"ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by", "bytes", "ops"}


@pytest.fixture
def small_smoke(monkeypatch):
    monkeypatch.setattr(chip_smoke, "LANES", LANES)
    monkeypatch.setattr(breakdown, "queued_ms", lambda fn, reps=20: 0.0)
    monkeypatch.setattr(chip_smoke, "_plain_ms", lambda fn: (0.0, fn()))
    return chip_smoke


def test_widths_cut_to_lanes(small_smoke):
    assert small_smoke._widths() == [1, 7, 16]


def test_phase_compare_on_cpu(small_smoke, capsys):
    results = small_smoke.phase_compare(0, "cpu")
    assert set(results) == set(KEYS)
    for name, res in results.items():
        assert ROW_KEYS <= set(res), name
        assert res["max_abs_err"] == 0, name
        assert res["bound_ms"] > 0 and res["bound_by"] in ("bytes", "operations"), name
    out = capsys.readouterr().out
    assert "raw limbs and valid identical to the plain version at widths [1, 7, 16]" in out
    assert "K1: raw limbs identical to the plain version at widths [1, 7, 16]" in out
    assert "K4: mask identical to the plain version at widths [1, 7, 16]" in out


def test_k4_lanes_by_construction(small_smoke):
    """K4's lambda-scaled, identity, non-canonical-R and invalid lanes: the
    mask known by construction is the plain version's, scaling changes no
    lane's mask, and each class is present."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops import ed25519 as ed
    from hotstuff_tpu_torch.ops import field

    rng = np.random.default_rng(5)
    n = LANES
    lam = field.limbs_of_int([int(v) % field.P + 1 for v in rng.integers(1, 2**62, n)])
    pts = torch.stack([field.mul(field.limbs_of_int([int(v) for v in rng.integers(1, 2**62, n)]), lam)
                       for _ in range(4)]).to(torch.int32)
    enc = ed.compress(pts)
    xyzt, r, valid, want = small_smoke._k4_inputs(rng, pts, enc, torch.device("cpu"))
    assert ed.compress_eq_plain(xyzt, r, valid).tolist() == want
    scaled = [i for i in range(0, n, 3) if i not in small_smoke.K4_IDENTITY_R]
    assert torch.equal(ed.compress(xyzt)[:, scaled], enc[:, scaled])
    assert not torch.equal(xyzt[:, :, scaled], pts[:, :, scaled])
    assert [want[i] for i in small_smoke.K4_IDENTITY_R] == [True, False, False]
    assert not valid[5] and not want[5] and want[0] and not want[7]


def test_phase_committee_compare_on_cpu(small_smoke, capsys):
    seeds = [hashlib.sha256(b"validator %d" % i).digest() for i in range(6)]
    keys = [pysigner.keypair_from_seed(s)[0] for s in seeds] + small_smoke._committee_special_keys()
    results = small_smoke.phase_committee_compare(0, keys, "cpu")
    assert set(results) == {"committee_ladder", "h_digits_idx"}
    for name, res in results.items():
        assert ROW_KEYS <= set(res), name
        assert res["max_abs_err"] == 0, name
    out = capsys.readouterr().out
    assert "K5: raw limbs and lane_valid identical to the plain version at widths [1, 7, 16]" in out


def test_spill_bytes_parses_ptxas():
    from hotstuff_tpu_torch.ops import _build

    clean = ("ptxas info    : Used 96 registers | 0 bytes stack frame, 0 bytes spill stores, "
             "0 bytes spill loads")
    assert _build.spill_bytes(clean) == 0
    assert _build.spill_bytes(clean.replace("0 bytes spill stores", "24 bytes spill stores")) == 24
    assert _build.spill_bytes("") == 0


def test_stack_bytes_parses_ptxas():
    """K6's and K8's gate (NO_STACK): stack frames summed over every function of a
    source's report, as `phase_build` reads them."""
    from hotstuff_tpu_torch.ops import _build

    report = ("ptxas info    : Compiling entry function 'a' | 0 bytes stack frame, 0 bytes spill stores, 0 bytes "
              "spill loads | ptxas info    : Compiling entry function 'b' | 32 bytes stack frame, 64 bytes spill "
              "stores, 64 bytes spill loads")
    assert _build.stack_bytes(report) == 32 and _build.spill_bytes(report) == 128
    assert _build.stack_bytes(report.replace("32 bytes stack", "0 bytes stack")) == 0
    assert set(chip_smoke.NO_STACK) <= set(chip_smoke.NO_SPILL)
    assert {"g1_aggregate", "field12"} <= set(chip_smoke.NO_STACK)


def test_phase_reduce_compare_on_cpu(small_smoke, capsys):
    """The reduction phase's values are the reduction tests' own: the 11
    edge values and the 4,096-value sweep (its first rows all-ones with a
    zero byte, rows 256..511 near multiples of L)."""
    edges, sweep = small_smoke._reduce_values()
    assert len(edges) == 11 and len(sweep) == 4096
    assert all(0 <= v < 2**512 for v in edges + sweep)
    assert sum(v % pysigner.L < 4 or pysigner.L - v % pysigner.L < 4 for v in sweep[256:512]) == 256
    results = small_smoke.phase_reduce_compare("cpu")
    assert set(results) == {"reduce_mod_l"}
    res = results["reduce_mod_l"]
    assert ROW_KEYS <= set(res) and res["max_abs_err"] == 0
    assert res["bytes"] == 4096 * 96 and res["bound_by"] in ("bytes", "operations")
    assert "on 11 edge values and the 4096-value sweep" in capsys.readouterr().out


# -- phases 6 and 7: the sidecar's load and the committee run ------------------


class _InlinePool:
    """`Pool.map` in this process."""

    def map(self, fn, iterable, chunksize=1):
        return [fn(x) for x in iterable]


def test_sidecar_requests_cut_a_pass_into_payload_sized_requests():
    import numpy as np

    n = chip_smoke.SIDECAR_PASS
    lanes = list(range(2 * n))
    reqs = chip_smoke._requests(lanes, lanes, lanes, np.ones(2 * n, bool), n, 2 * n)
    sizes = [len(m) for m, _, _, _ in reqs]
    assert sizes == [chip_smoke.SIDECAR_REQUEST] * (n // 976) + [n % 976]
    assert reqs[0][0][0] == n and reqs[-1][0][-1] == 2 * n - 1
    assert all(len(set(map(len, r[:3]))) == 1 and len(r[3]) == len(r[0]) for r in reqs)
    assert min(sizes) >= 256  # every bulk request stays off the urgent lane


def test_sidecar_corpus_is_distinct_and_agrees_with_openssl(monkeypatch):
    pytest.importorskip("cryptography")
    monkeypatch.setattr(chip_smoke, "SIDECAR_PASS", 32)
    monkeypatch.setattr(chip_smoke, "SIDECAR_KEYS", 4)
    M, K, S, expected = chip_smoke._sidecar_corpus(0, _InlinePool())
    n = (chip_smoke.SIDECAR_PASSES + chip_smoke.SIDECAR_TRACED) * 32
    assert len(M) == n and len(set(zip(M, K, S))) == n and len(set(M)) >= n - n // 16
    assert int((~expected).sum()) == n // 16
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature

    verify = chip_smoke._openssl_verifier()
    assert verify(M, [PublicKey(k) for k in K], [Signature(s) for s in S]) == expected.tolist()


def test_urgent_timeline_splits_each_round_trip():
    """Two urgent requests of 3 lanes among bulk records of 9: each round
    trip splits into its segments, a collector pause inside it counts, and
    a request without a backend call is reported as unmatched."""
    times = [(10.0, 10.1), (20.0, 20.2), (30.0, 30.1)]
    submits = [(10.02, 10.09, 0.0, 3), (10.0, 10.5, 0.0, 9), (20.05, 20.15, 0.0, 3), (30.01, 30.09, 0.0, 3)]
    calls = [(10.03, 10.07, 0.01, 3), (10.03, 10.08, 0.0, 9), (20.06, 20.14, 0.02, 3)]
    parses = [(9.0, 9.1, 0.0, 3), (10.005, 10.01, 0.0, 3), (10.0, 10.01, 0.0, 9), (20.01, 20.04, 0.0, 3),
              (30.0, 30.005, 0.0, 3)]
    gcs = [(20.1, 20.13, 2), (25.0, 26.0, 0)]
    rows, unmatched = chip_smoke.urgent_timeline(times, submits, calls, parses, gcs, 3)
    assert unmatched == 1 and len(rows) == 2
    want = [dict(rtt=100, wait=5, parse=5, queue=10, backend=40, backend_cpu=10, resolve=20, reply=10, gc=0),
            dict(rtt=200, wait=10, parse=30, queue=10, backend=80, backend_cpu=20, resolve=10, reply=50, gc=30)]
    for row, w in zip(rows, want):
        assert row.keys() == w.keys()
        assert all(abs(row[k] - w[k]) < 1e-6 for k in w), (row, w)


def test_timers_record_calls_and_restore():
    """`_Timed` records each call of a plain and a coroutine function with
    its size, and puts both back; `_GcPauses` sees a forced collection."""
    import asyncio
    import gc
    import types

    owner = types.SimpleNamespace(f=lambda xs: sum(xs))

    async def g(xs):
        await asyncio.sleep(0)
        return list(xs)

    owner.g = g
    f = owner.f
    plain, coro = chip_smoke._Timed(owner, "f", lambda a, r: len(a[0])), chip_smoke._Timed(owner, "g", lambda a, r: len(r))
    pauses = chip_smoke._GcPauses()
    try:
        assert owner.f([1, 2, 3]) == 6
        assert asyncio.run(owner.g([1, 2])) == [1, 2]
        gc.collect()
        (rec,), (crec,) = plain.take(), coro.take()
        assert rec[3] == 3 and crec[3] == 2 and rec[0] <= rec[1] and plain.take() == []
        assert any(gen == 2 and a <= b for a, b, gen in pauses.take())
    finally:
        plain.restore()
        coro.restore()
        pauses.close()
    assert owner.f is f and owner.g is g


def test_node_configs_read_back_by_the_reference(tmp_path):
    from hotstuff_tpu.consensus.config import Committee as ConsensusCommittee
    from hotstuff_tpu.node.config import Committee, NodeParameters, Secret

    names = [Secret.new().name.encode_base64() for _ in range(4)]
    ports = list(range(30_000, 30_012))
    committee, parameters = chip_smoke.write_node_configs(tmp_path, names, ports)
    c = Committee.read(str(committee))
    addresses = {k.encode_base64(): c.consensus.address(k) for k in c.consensus.authorities}
    assert addresses == {name: ("127.0.0.1", p) for name, p in zip(names, ports[:4])}
    assert c.consensus.quorum_threshold() == 3
    assert isinstance(c.consensus, ConsensusCommittee)
    p = NodeParameters.read(str(parameters))
    assert p.mempool.benchmark_mode is True
    assert (p.consensus.timeout_delay, p.consensus.max_payload_size, p.mempool.max_payload_size) == (1_000, 1_000, 15_000)
    assert p.consensus.min_block_delay == 0 and p.mempool.min_block_delay == 0


_LOG = """\
[2026-10-17T05:40:56.101Z INFO hotstuff.consensus] Committed B1(AAAA+/==)
[2026-10-17T05:40:56.102Z INFO hotstuff.consensus] Committed B1(AAAA+/==) -> cGF5bG9hZA==
[2026-10-17T05:40:56.201Z INFO hotstuff.consensus] Committed B2(BBBB)
[2026-10-17T05:40:56.301Z INFO hotstuff.mempool] Verifying OWN transaction batch. Size: 24
"""


def test_commit_parser_and_digest_agreement():
    assert chip_smoke.committed_blocks(_LOG) == {1: "AAAA+/==", 2: "BBBB"}
    lagging = _LOG.replace("Committed B2(BBBB)", "Created B2(BBBB)")
    commits = chip_smoke.check_commits({"node-0": _LOG, "node-1": lagging})
    assert commits == {"node-0": {1: "AAAA+/==", 2: "BBBB"}, "node-1": {1: "AAAA+/=="}}
    forked = _LOG.replace("Committed B2(BBBB)", "Committed B2(CCCC)")
    with pytest.raises(SystemExit, match="round 2"):
        chip_smoke.check_commits({"node-0": _LOG, "node-1": forked})
    with pytest.raises(SystemExit, match="committed no block"):
        chip_smoke.check_commits({"node-0": _LOG, "node-1": "no commits here\n"})


def test_read_device_trace_unions_intervals_and_finds_the_default_stream():
    """`breakdown.read_device_trace` on a hand-made Chrome trace: the spin
    marker names the default stream and is left out; kernels and copies on
    two side streams overlap, so the union is shorter than the sum; a
    kernel on the default stream is reported; a trace without the marker
    raises."""
    ev = lambda cat, name, ts, dur, stream: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                                            "args": {"stream": stream}}
    trace = {"traceEvents": [
        ev("kernel", "spin_kernel(long)", 0.0, 1.0, 7),
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 10.0, 2.0, 13),
        ev("kernel", "ladder_kernel", 12.0, 6.0, 13),
        ev("kernel", "h_digits_kernel", 14.0, 6.0, 17),
        ev("kernel", "compress_eq_kernel", 30.0, 4.0, 7),
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0.0, "dur": 50.0},
    ]}
    res = breakdown.read_device_trace(trace, 50e-6)
    assert res["device_ms"] == pytest.approx(14e-3) and res["device_ms_sum"] == pytest.approx(18e-3)
    assert res["busy_share"] == pytest.approx(14 / 50)
    assert res["streams"] == {"13": 2, "17": 1, "7": 1} and res["default_stream"] == "7"
    assert res["on_default_stream"] == 1 and res["on_default_names"] == ["compress_eq_kernel"]
    assert res["kernels"] == 3
    with pytest.raises(RuntimeError, match="marker"):
        breakdown.read_device_trace({"traceEvents": trace["traceEvents"][1:]}, 50e-6)


def test_device_trace_takes_the_trace_again_when_its_markers_are_lost(monkeypatch, tmp_path):
    """The profiler now and then loses events on the card, the markers too:
    `device_trace` then runs its work under the profiler again, up to
    `tries` times in all, and raises when every trace lost them."""
    runs, results = [], [breakdown.TraceIncomplete("lost"), breakdown.TraceIncomplete("lost"), {"kernels": 4}]

    def once(run, trace_path):
        run()
        res = results.pop(0)
        if isinstance(res, Exception):
            raise res
        return res

    monkeypatch.setattr(breakdown, "_trace_once", once)
    assert breakdown.device_trace(lambda: runs.append(1), tmp_path / "t.json") == {"kernels": 4}
    assert len(runs) == breakdown.TRACE_TRIES == 3
    results[:] = [breakdown.TraceIncomplete("lost")] * 2
    with pytest.raises(breakdown.TraceIncomplete, match="lost"):
        breakdown.device_trace(lambda: runs.append(1), tmp_path / "t.json", tries=2)
    assert len(runs) == 5 and not results


def test_trace_kernel_counts_and_traced_launches():
    """`read_device_trace` counts kernels per name; `traced_launches` finds
    each hand-written kernel by its CUDA symbol, in or out of a namespace,
    without taking K7's `bit_ladder_kernel` for K1's `ladder_kernel`."""
    ev = lambda name, stream: {"ph": "X", "cat": "kernel", "name": name, "ts": 0.0, "dur": 1.0,
                               "args": {"stream": stream}}
    names = ["ladder_kernel(unsigned char const*, int*)", "(anonymous namespace)::bit_ladder_kernel(int)",
             "(anonymous namespace)::bit_ladder_kernel(int)", "decompress_table_kernel(int)"]
    trace = {"traceEvents": [ev("spin_kernel(long)", 7)] + [ev(n, 13) for n in names]}
    res = breakdown.read_device_trace(trace, 1e-3)
    assert res["kernel_counts"] == {names[0]: 1, names[1]: 2, names[3]: 1}
    assert chip_smoke.traced_launches(res, ("bit_ladder", "ladder", "decompress_table", "compress_eq")) == {
        "bit_ladder": 2, "ladder": 1, "decompress_table": 1, "compress_eq": 0}


# -- phase 5b: the sharded verifier on a mesh ----------------------------------


def test_mesh_phase_meshes_and_launch_check():
    """The phase's meshes on the CPU (one shard, then virtual meshes of 2
    and 4 shards on it), and the launch check: each path kernel at shards
    x the single-device count, every other kernel at 0."""
    import torch

    ms = chip_smoke.meshes("cpu")
    assert list(ms) == ["1 CPU", "virtual 2", "virtual 4"]
    assert [m.size for m in ms.values()] == [1, 2, 4]
    assert all(m.distinct == (torch.device("cpu"),) for m in ms.values())
    single = {"ladder": 4, "h_digits": 4, "decompress_table": 4, "compress_eq": 4, "committee_ladder": 0}
    ok = {"ladder": 8, "h_digits": 8, "decompress_table": 8, "compress_eq": 8, "committee_ladder": 0}
    assert chip_smoke.mesh_launch_errors(ok, single, chip_smoke.GENERIC_KERNELS, 2) == []
    bad = dict(ok, ladder=4, committee_ladder=1)
    assert chip_smoke.mesh_launch_errors(bad, single, chip_smoke.GENERIC_KERNELS, 2) == [
        "ladder: 4 != 2 x 4", "committee_ladder: 1 launches off the path"]


def test_mesh_phase_qc_wire_pads_each_qc_to_the_dp_axis():
    """`qc_wire`: QC-major (Q, 128, B) wire lanes equal to the staged votes,
    each QC padded to a multiple of the "dp" size with lanes whose s < L bit
    is off, and the expected counts the per-QC sums of the expected mask."""
    import numpy as np

    from hotstuff_tpu_torch.ops import ed25519 as ed

    seeds = [hashlib.sha256(b"qc voter %d" % i).digest() for i in range(3)]
    pks = [pysigner.keypair_from_seed(s)[0] for s in seeds]
    M = [hashlib.sha256(b"qc %d" % (i // 3)).digest() for i in range(6)]
    K = [pks[i % 3] for i in range(6)]
    S = [bytes(64)] * 6
    expected = [True, False, True, True, True, True]
    packed, s_ok, want, counts = chip_smoke.qc_wire((M, K, S, expected), 3, 2)
    staged = ed.prepare_batch_packed_dh(M, K, S)["packed"]
    assert packed.shape == (2, 128, 4) and packed.flags.c_contiguous and s_ok.shape == want.shape == (2, 4)
    assert np.array_equal(packed[1, :, :3], staged[:, 3:6]) and np.array_equal(packed[1, :, 3], staged[:, 3])
    assert s_ok[:, 3].tolist() == [False, False] and want[:, 3].tolist() == [False, False]
    assert counts.tolist() == [2, 3]



def _staging_corpus(n_batch: int, n_votes: int):
    """Random wire bytes shaped as phase 3's batch and phase 5's votes (the
    staging does not look at validity)."""
    import numpy as np

    rng = np.random.default_rng(5)

    def rows(n, w):
        return [bytes(r) for r in rng.integers(0, 256, (n, w), np.uint8)]

    keys = rows(7, 32)
    batch = (rows(n_batch, 32), rows(n_batch, 32), rows(n_batch, 64), np.ones(n_batch, bool))
    votes = (rows(n_votes, 32), [keys[i % 7] for i in range(n_votes)], rows(n_votes, 64), np.ones(n_votes, bool))
    return batch, votes


def test_staging_cases_cover_the_phase(monkeypatch):
    """Phase 3b's cases: every form at shards 1, 2 and 4 on its whole
    batch, in a reused buffer at a width above n, the host-hash forms over
    messages of 0..300 bytes, and every form with s = L - 1, L, 2^256 - 1."""
    batch, votes = _staging_corpus(400, 401)
    forms = chip_smoke.staging_forms(batch, votes)
    assert sorted(forms) == sorted(chip_smoke.STAGING_PATHS)
    cases = chip_smoke.staging_cases(forms, 320)
    for name in forms:
        mine = [c for c in cases if c[1] == name]
        assert {c[4] for c in mine if "n=" in c[0] and not c[5]} == {1, 2, 4}
        assert [c[3] > len(c[2][0]) for c in mine if c[5]] == [True, True]
        edge = [c for c in mine if "s in" in c[0]][0]
        s = [int.from_bytes(sig[32:], "little") for sig in edge[2][-1][:9:3]]
        assert s == list(chip_smoke.EDGE_S)
        lengths = {len(m) for c in mine if "messages" in c[0] for m in c[2][0]}
        assert lengths == (set(range(chip_smoke.MSG_LENGTHS)) if name.endswith("_hh") else set())


def test_staging_diff_finds_what_differs():
    """`staging_diff` is empty on the native plane, and names a pad lane
    left dirty and a wrong s < L bit."""
    import numpy as np

    batch, votes = _staging_corpus(20, 20)
    native, plain, args, rows = chip_smoke.staging_forms(batch, votes)["packed_dh"]
    assert chip_smoke.staging_diff(native, plain, args, rows, 32, 2) == []

    def dirty_pads(*a):
        out = a[-3]
        got = native(*a)
        out[1, :, -1] = 7
        return dict(got, s_ok=~got["s_ok"])

    bad = chip_smoke.staging_diff(dirty_pads, plain, args, rows, 32, 2)
    assert len(bad) == 2 and "wire bytes differ at (shard, row, lane) [[1, 0, 15]" in bad[0] and "s_ok" in bad[1]
    out = np.zeros((2, rows, 16), np.uint8)
    assert chip_smoke.staging_diff(native, plain, args, rows, 32, 2, out) == [] and out.any()


def test_phase_staging_on_cpu(monkeypatch, capsys):
    """Phase 3b end to end at a 64-lane chunk on the CPU: every case equal,
    then stage ms of both stagings per form."""
    monkeypatch.setattr(chip_smoke, "CHUNK", 64)
    batch, votes = _staging_corpus(150, 129)
    res = chip_smoke.phase_staging(batch, votes, "cpu")
    assert sorted(res) == sorted(chip_smoke.STAGING_PATHS)
    for r in res.values():
        assert r["native"]["median_ms"] > 0 and r["numpy"]["median_ms"] > 0 and r["numpy_over_native"] > 0
    out = capsys.readouterr().out
    assert "native == numpy byte for byte" in out and "staging ms per 64-lane chunk" in out


def _bls_pairs(n: int):
    from hotstuff_tpu_torch.crypto import aggsig

    scheme = aggsig.ExactBlsScheme()
    return [scheme.keypair_from_seed(b"bls %d" % i) for i in range(n)]


def test_bls_corpus_and_bound_count():
    """Phase 8's tables and rows: the special lanes hold what they claim
    (each key is its secret times the generator), the rows are the edge
    rows then quorums of floor(2n/3) + 1, and the bound counts one mixed add
    (7 products, 4 squarings) per member beyond a row's first, the
    undecodable lane left out; the affine entry's adds a batch inversion's
    work for each row that is not the identity and one chain a launch."""
    import numpy as np

    from hotstuff_tpu_torch import bls_corpus
    from hotstuff_tpu_torch.crypto import aggsig
    from hotstuff_tpu_torch.ops import bls

    for n in (4, 40):
        keys, sks, lanes = bls_corpus.table_keys(_bls_pairs(n), n)
        assert len(keys) == len(sks) == n and sks[-1] is None
        with pytest.raises(ValueError):
            aggsig.decompress_g1(keys[-1])
        for k, sk in zip(keys[:-1], sks[:-1]):
            assert k == aggsig.compress_g1(aggsig._FP_OPS.mul_affine(aggsig.G1_GEN, sk))
        a, b = lanes["dup"]
        assert keys[a] == keys[b] and b == n - 3
        a, b = lanes["inverse"]
        assert aggsig.decompress_g1(keys[b]) == aggsig._g1_neg(aggsig.decompress_g1(keys[a]))
        assert ("dup_one_partial" in lanes) == (n > bls.THREADS + 2)
        masks, labels = bls_corpus.bitmap_rows(0, n, lanes, 12)
        assert labels[:3] == ["empty", "all", "single"] and masks.shape == (12, n)
        assert masks[0].sum() == 0 and masks[1].all() and masks[2].sum() == 1
        for r, name in enumerate(labels[3:], 3):
            assert np.flatnonzero(masks[r]).tolist() == sorted(lanes[name])
        assert all(masks[r].sum() == 2 * n // 3 + 1 for r in range(len(labels), 12))
        present = np.array([sk is not None for sk in sks])
        moved, ops = chip_smoke.bls_bound(masks, present)
        members = [int((row & present).sum()) for row in masks]
        assert ops == sum(max(m - 1, 0) for m in members) * (7 * 300 + 4 * 234)
        assert moved == 12 * n + n * 97 + 12 * 144
        identity = np.array([m == 0 for m in members])
        moved_aff, ops_aff = chip_smoke.bls_bound(masks, present, identity)
        convert = 12 - int(identity.sum())
        assert 0 < convert < 12
        assert ops_aff == ops + convert * (6 * 300 + 234 + 2 * 156) + 378 * 234 + 82 * 300
        assert moved_aff == 12 * n + n * 97 + 12 * 97
        assert chip_smoke.bls_bound(masks[:1], present, identity[:1])[1] == 0


def test_bls_off_path_errors():
    ok = {"main path": {"g1_aggregate": 0, "bls_mont_mul": 0, "ladder": 4}}
    assert chip_smoke.bls_off_path_errors(ok) == []
    bad = {"sidecar": {"g1_aggregate": 2, "bls_mont_mul": 0}}
    assert chip_smoke.bls_off_path_errors(bad) == ["sidecar: g1_aggregate launched 2 times"]


def test_phase_bls_on_cpu(small_smoke, monkeypatch, capsys):
    """Phase 8 at 4 and 16 validators, 8 rows, `verify_aggregate` at 16:
    the corpus, the exact fold in the spawn pool, the verdicts and the
    comparisons (both sides plain here) and the result rows."""
    monkeypatch.setattr(chip_smoke, "BLS_SIZES", (4, 16))
    monkeypatch.setattr(chip_smoke, "BLS_ROWS", 8)
    monkeypatch.setattr(chip_smoke, "BLS_VERIFY_SIZES", (16,))
    monkeypatch.setattr(chip_smoke, "BLS_POOL", 2)
    res = small_smoke.phase_bls(0, "cpu")
    assert set(res["kernels"]) == {"g1_aggregate", "g1_aggregate_affine", "bls_mont_mul"}
    for name, row in res["kernels"].items():
        assert ROW_KEYS <= set(row), name
        assert row["max_abs_err"] == 0 and row["bound_ms"] > 0, name
    assert res["kernels"]["g1_aggregate"]["bound_by"] == "operations"
    assert res["kernels"]["g1_aggregate_affine"]["bound_by"] == "operations"
    assert res["kernels"]["g1_aggregate_affine"]["ops"] > res["kernels"]["g1_aggregate"]["ops"]
    assert set(res["kernels"]["g1_aggregate"]["extra"]["table_build_s"]) == {4, 16}
    out = capsys.readouterr().out
    assert "every affine sum equals the exact add_affine fold at N = [4, 16]" in out
    assert "verify_aggregate verdicts {16: [True, False, False, False]} as expected" in out
    assert "both entries identical to their plain versions (limbs, flags) at N = [4, 16] with B = 8 and B = 1" in out
    assert "aggregate_masks at N = 16, B = 8" in out and "affine_of_limbs" in out
    assert "bls_mont_mul: kernel equals the plain mont_mul and Python ints on 4096 pairs" in out


def test_phase_f32_on_cpu(small_smoke, monkeypatch, capsys):
    """Phase 9 at 128 lanes: K7 against its plain version (both plain here)
    at widths 7, MAX_BUCKET and 128, the three flavours of `packed=False` on a
    12-signature batch with every corruption class, the s + 2^253 raw
    masks, and `sharded_verify` and the sharded verifier on the CPU meshes
    of 1, 2 and 4 shards; the result row and the bound."""
    import numpy as np

    monkeypatch.setattr(chip_smoke, "LANES", 128)
    monkeypatch.setattr(chip_smoke, "MAX_BUCKET", 16)
    monkeypatch.setattr(chip_smoke, "F32_ITERS", 1)
    monkeypatch.setattr(chip_smoke, "F32_HIGH_S", 2)
    monkeypatch.setattr(chip_smoke, "F32_MESH_KERNELS", ("bits",))
    seeds = [hashlib.sha256(b"f32 %d" % i).digest() for i in range(12)]
    M = [hashlib.sha256(s).digest() for s in seeds]
    K, S = [], []
    for seed, m in zip(seeds, M):
        pk = pysigner.keypair_from_seed(seed)[0]
        K.append(pk)
        S.append(pysigner.sign(seed, m, public_key=pk))
    expected = small_smoke._corrupt_lanes(M, K, S, np.arange(6))
    res = small_smoke.phase_f32(0, (M, K, S, expected), "cpu")
    row = res["kernel"]
    assert ROW_KEYS <= set(row) and row["max_abs_err"] == 0
    assert row["bound_by"] == "operations" and row["bound_ms"] > 0
    assert set(res["rates"]) == {"bits", "w4", "pallas"}
    out = capsys.readouterr().out
    assert "K7: raw limbs identical to the plain version at widths [7, 16, 128]" in out
    assert set(res["mesh_launches"]) == {"1 CPU", "virtual 2", "virtual 4"}
    for k in ("bits", "w4", "pallas"):
        assert f"f32 path {k}: 12 signatures in 1 pieces, mask == expected" in out
    assert "ShardedEd25519TorchVerifier(packed=False, kernel='bits') on meshes ['1 CPU', 'virtual 2', " \
           "'virtual 4']: masks == expected" in out


def test_bit_ladder_bound_counts_set_bits():
    import torch

    s = torch.zeros((253, 4), dtype=torch.uint8)
    h = torch.zeros((253, 4), dtype=torch.uint8)
    s[0, 0] = h[5, 1] = h[6, 1] = 1
    bytes_moved, ops = chip_smoke.bit_ladder_bound(s, h)
    assert ops == 4 * 253 * (4 * 55 + 4 * 100) + 3 * 7 * 100
    assert bytes_moved == 4 * (2 * 253 + 120 + 160) + 120
    assert chip_smoke.k7_off_path_errors({"a": {"bit_ladder": 0}, "b": {"bit_ladder": 2}}) == [
        "b: bit_ladder launched 2 times"]
    report = ("ptxas info    : Used 96 registers, used 0 barriers, 360 bytes cmem[0]\n"
              "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads")
    assert chip_smoke.ptxas_numbers(report) == dict(registers=96, stack=8, spills=8)


def test_phase_field12_on_cpu(small_smoke, capsys):
    """Phase 10's comparisons at 16 lanes: K8 against its plain version (both
    plain here) for every case at widths 1, 7 and 16, canonical against
    v mod p on the 264-bit domain, the tool's two kernels against their
    plain chains; the rows, bounds and launch bookkeeping."""
    rows = small_smoke.phase_field12(0, "cpu")
    assert set(rows) == set(small_smoke.TUNING_KERNELS)
    for name, row in rows.items():
        assert ROW_KEYS <= set(row) and row["max_abs_err"] == 0, name
        assert row["bound_ms"] > 0 and row["bound_by"] in ("bytes", "operations"), name
        assert row["extra"]["compare_launches"] == 0, name  # plain on the CPU: no launch
    assert rows["field12"]["ops"] == 16 * 64 * 253 and rows["field12"]["bound_by"] == "operations"
    assert rows["field12_mul"]["ops"] == 16 * 484 and rows["field_sqr_n"]["ops"] == 16 * 64 * 55
    assert rows["alu_chain"]["ops"] == 64 * 64 * 16  # one IMAD a step of op 1
    assert rows["field12_sub"]["bound_by"] == rows["field12_canonical"]["bound_by"] == "bytes"
    out = capsys.readouterr().out
    assert "K8 layout: sqr_n and mul 4 threads a lane (one in each warp of a block of 32 lanes)" in out
    assert "products of a squaring [69, 69, 58, 57], of a product [132, 132, 110, 110]" in out
    assert "K8: uint32 limbs identical to the plain version at widths [1, 7, 16]" in out
    for label in ("'mul lazy'", "'sub lazy'", "'canonical 264-bit'", "'sqr_n 64 of products'"):
        assert label in out
    assert "canonical equal to v mod p on the 264-bit domain" in out


def test_phase_wide_compare_on_cpu(small_smoke, capsys):
    """Phase 10's hold of K2, K3, K1 and K4 at the tool's chunk widths, cut
    to 16, 8 and 4 lanes: the plain versions on both sides here, so this
    holds the inputs, the cuts and K4's mask known by construction."""
    launches = small_smoke.phase_wide_compare(0, "cpu", (16, 8, 4))
    assert set(KEYS) <= set(launches) and not any(launches.values())  # plain on the CPU: no launch
    out = capsys.readouterr().out
    assert "K2, K3, K1, K4 at the tool's chunk widths [16, 8, 4]: identical to their plain versions" in out


def test_field12_inputs_cover_the_edges(small_smoke):
    from hotstuff_tpu_torch.ops import field12 as f12

    t, cs = small_smoke.field12_inputs(0, "cpu")
    P = f12.P
    assert f12.int_of_limbs(t["x"])[:4] == [0, 1, P - 1, 2**255 - 20]
    assert cs[:6] == [P, P + 1, 2 * P - 1, 2 * P, 2**264 - 1, 500 * P + 7]
    assert int(t["lazy"].max()) > f12.MASK  # one lazy add runs limbs past 12 bits
    assert all(v.shape == (22, LANES) for v in t.values())


def test_tune_rows_launch_checks_and_entry_ptxas():
    rows = ["# devices: cpu", "vpu f32 mul+add 1", "vpu i32 mul+add 1", "vpu u32 xor/shift/add 1",
            "field int32 radix-2^25.5 1", "field u32 radix-2^12 1", "field check: both rows equal v",
            "phase decompress         fused into K3", "phase decompress+table 1", "phase ladder 1",
            "phase compress 1", "phase sha512+modL (dh) 1", "phase full verify 1", "chunk  2048 (bucket 8192)",
            "dh-compare host-hash 1", "dh-compare device-hash 1", "# launches: {}"]
    assert chip_smoke.tune_missing(rows, 1) == []
    assert chip_smoke.tune_missing(rows[:4] + rows[5:], 2) == ["field int32 radix-2^25.5", "2 chunk rows (1 printed)"]
    assert chip_smoke.off_path_errors({"a": {"field12": 0, "alu_chain": 3}}, chip_smoke.TUNING_KERNELS) == [
        "a: alu_chain launched 3 times"]
    report = ("ptxas info : Compiling entry function '_ZN3_GLOBAL24field12_canonical_kernelEPKjPji' | "
              "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers | "
              "ptxas info : Compiling entry function '_ZN3_GLOBAL14field12_kernelEPKjPjii' | "
              "0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads | Used 56 registers")
    assert chip_smoke.ptxas_numbers(chip_smoke.entry_ptxas(report, "field12")) == dict(
        registers=56, stack=0, spills=16)
    assert chip_smoke.ptxas_numbers(chip_smoke.entry_ptxas(report, "field12_canonical"))["registers"] == 64


def test_phase_tune_on_cpu(capsys):
    """Phase 10's run of the tuning tool, on the CPU with its small sizes:
    exit 0, every leg's rows echoed, the launch line read back."""
    assert chip_smoke.phase_tune("cpu") == {}
    out = capsys.readouterr().out
    assert "tune_device| field check: both rows equal v^(2^4) mod p on all 16 lanes" in out
    assert "tune_device --all: exit 0, every leg's rows" in out


def test_bench_kernels_of_each_phase_11_run():
    """The kernels each of phase 11's runs must launch, and no others."""
    want = {
        "committee cache on": chip_smoke.PACKED_KERNELS | chip_smoke.COMMITTEE_PATH_KERNELS,
        "committee cache off": chip_smoke.PACKED_KERNELS,
        "bits": {"decompress_table", "bit_ladder", "compress_eq"},
        "mesh": chip_smoke.PACKED_KERNELS,
        "pipeline A/B": chip_smoke.PACKED_KERNELS,
        "committee scale": chip_smoke.COMMITTEE_PATH_KERNELS,
    }
    for label, flags in chip_smoke.BENCH_RUNS:
        assert chip_smoke.bench_kernels([*chip_smoke.BENCH_BASE, *flags]) == want[label], label
    assert chip_smoke.bench_kernels(["--kernel", "pallas"]) == chip_smoke.PACKED_KERNELS
    assert chip_smoke.bench_kernels(["--kernel", "bits", "--committee-cache", "on"]) == {
        "decompress_table", "bit_ladder", "compress_eq"} | chip_smoke.COMMITTEE_PATH_KERNELS
    assert chip_smoke.bench_kernels(["--kernel", "bits", "--committee-cache", "off"]) == {
        "decompress_table", "bit_ladder", "compress_eq"}


def test_bench_line_and_errors():
    line = chip_smoke.bench_line('# a table\n{"backend": "cuda", "value": 2.5}\n')
    assert line == {"backend": "cuda", "value": 2.5}
    for bad in ("", "table only\n", '["a list"]\n'):
        with pytest.raises(SystemExit, match="FAIL"):
            chip_smoke.bench_line(bad)
    dump = {"counters": {k: 0 for k in chip_smoke.ROUTING_COUNTERS}, "histograms": {"crypto.batch_size": {}}}
    want = {"ladder", "compress_eq"}
    launches = {"ladder": 4, "compress_eq": 4, "bit_ladder": 0}
    assert chip_smoke.bench_errors(line, launches, want, dump) == []
    errors = chip_smoke.bench_errors({"backend": "cpu", "value": 0}, {**launches, "bit_ladder": 1}, want,
                                     {"counters": {}, "histograms": {}})
    assert len(errors) == 4 and "launched ['bit_ladder', 'compress_eq', 'ladder']" in errors[2]
    assert chip_smoke.bench_errors({"backend": "cpu", "value": 1.0}, {}, want, dump, device="cpu") == []


def test_phase_bench_on_cpu(monkeypatch, capsys):
    """Phase 11 on the CPU at 128 lanes: the default leg with the committee
    leg, and the committee-scale table cut to three committees."""
    from hotstuff_tpu_torch import bench

    monkeypatch.setattr(bench, "COMMITTEE_SIZES", (4, 10, 64))
    base = ("--batch", "86", "--device-batch", "64", "--chunk", "128", "--iters", "1", "--e2e-iters", "1",
            "--cpu-budget", "0.05")
    runs = tuple(r for r in chip_smoke.BENCH_RUNS if r[0] in ("committee cache on", "committee scale"))
    out = chip_smoke.phase_bench("cpu", base=base, runs=runs)
    assert set(out) == {"committee cache on", "committee scale"}
    assert out["committee cache on"]["line"]["committee_cache"] == "on"
    rows = out["committee scale"]["line"]["committee_scale"]
    assert [r["route"] for r in rows] == ["openssl", "openssl", "card"]
    text = capsys.readouterr().out
    assert "bench committee scale| committee  quorum" in text and "phase 11 (the port's bench): 2 runs" in text
    assert "bench committee cache on: telemetry scrape of 127.0.0.1 ok" in text and bench.TELEMETRY_PORT is None


def test_phase_12_gates():
    """What phase 12's gates hold, on made-up lines and launch counts."""
    rows = [{"n": n, "entry_list": {"cert_bytes": 44 + 96 * n}, "aggregate": {"cert_bytes": 204}}
            for n in chip_smoke.AGG_SIZES]
    agg = {"all_verified": True, "sizes": rows, "agg_bytes_spread": 1.0}
    k6 = {"g1_aggregate_affine": 4, "ladder": 0}
    assert [r["entry_list"]["cert_bytes"] for r in rows[:3]] == [428, 1580, 6188]
    assert chip_smoke.aggregate_errors(agg, k6, chip_smoke.AGG_SIZES) == []
    bad = {**agg, "all_verified": False, "agg_bytes_spread": 1.2,
           "sizes": [{**rows[0], "aggregate": {"cert_bytes": 205}}, *rows[1:]]}
    errors = chip_smoke.aggregate_errors(bad, {**k6, "ladder": 1}, chip_smoke.AGG_SIZES)
    assert len(errors) == 4 and "launched" in errors[-1]
    assert chip_smoke.aggregate_errors(agg, {}, (4, 16), device="cpu")[0].startswith("sizes")

    leg = lambda loop: {"verified_per_sec": 10.0, "flushes": 3, "masks_all_true": True, "flush_loop": loop}
    sched = {"legacy": leg("BatchVerificationService._run_legacy"), "scheduler": leg("DeviceScheduler.run")}
    packed = {k: 7 for k in chip_smoke.PACKED_KERNELS}
    assert chip_smoke.scheduler_errors(sched, packed) == []
    swapped = {"legacy": sched["scheduler"], "scheduler": {**sched["legacy"], "masks_all_true": False}}
    assert len(chip_smoke.scheduler_errors(swapped, {**packed, "committee_ladder": 1})) == 4

    line = {"offered": 10, "committed": 8, "pipeline": {"accepted": 8}}
    dump = {"counters": {"ingress.rejected_sigs": 0, "ingress.forwarded": 8}}
    assert chip_smoke.ingress_errors(line, {"ladder": 1}, dump) == []
    assert chip_smoke.ingress_errors(line, {}, dump) == []  # at 100 tx/s the host route may take every batch
    errors = chip_smoke.ingress_errors({**line, "committed": 7}, {"g1_aggregate_affine": 1},
                                       {"counters": {"ingress.rejected_sigs": 2, "ingress.forwarded": 8}})
    assert len(errors) == 3
    curve = {"rate": 100.0, "peak": 500.0, "t_start": 10 / 3, "t_end": 20 / 3}
    assert round(chip_smoke.curve_offered(curve, 10.0)) == 2333


def test_trace_errors(tmp_path):
    from hotstuff_tpu_torch.utils import tracing

    good = tmp_path / "good.json"
    tracing.write_json(str(good))
    assert chip_smoke._trace_errors(good) == []
    (tmp_path / "bad.json").write_text("{")
    assert "does not load" in chip_smoke._trace_errors(tmp_path / "bad.json")[0]
    (tmp_path / "other.json").write_text("{}")
    assert "keys" in chip_smoke._trace_errors(tmp_path / "other.json")[0]
    assert "does not load" in chip_smoke._trace_errors(tmp_path / "missing.json")[0]


def test_phase_bench_legs_on_cpu(monkeypatch, capsys):
    """Phase 12 on the CPU: the AggQC leg at 4 validators, the scheduler
    A/B at 0.5 s a leg, one ingress run of 0.5 s, and the forced ingress
    check at 32 transactions in two batches of 16 (the plain kernels)."""
    monkeypatch.setattr(chip_smoke, "FORCED_TXS", 32)
    monkeypatch.setattr(chip_smoke, "FORCED_BATCH", 16)
    out = chip_smoke.phase_bench_legs(
        0, "cpu", agg_sizes=(4,), sched_flags=("--sched-duration", "0.5", "--sched-bulk", "4"),
        ingress_runs=(("ingress 20 tx/s", ("--ingress-rate", "20", "--ingress-duration", "0.5")),))
    assert set(out) == {"aggregate A/B", "scheduler A/B", "ingress 20 tx/s", "forced ingress"}
    assert out["forced ingress"]["launches"] == {}.fromkeys(out["forced ingress"]["launches"], 0)
    text = capsys.readouterr().out
    assert "aggregate A/B n=4: QC 428 B" in text and "scheduler A/B legacy (BatchVerificationService._run_legacy)" in text
    assert "forced ingress check: 32 transactions, 2 with a flipped signature bit, in 2 batches of 16" in text
    assert "phase 12 (the bench's AggQC, scheduler and ingress legs): 4 runs" in text


def test_port_committee_command_lines():
    """Phase 13's node and client command lines parse under the port's
    CLIs: `--crypto torch` on the card, crossover 1, a metrics dump each."""
    import argparse
    from unittest import mock

    from hotstuff_tpu_torch.node import client as node_client
    from hotstuff_tpu_torch.node import main as node_main

    cmd = chip_smoke.port_node_cmd("py", 2, ".committee.json", ".parameters.json", "metrics-2.json")
    assert cmd[:4] == ["py", "-m", "hotstuff_tpu_torch.node.main", "-vv"]
    args = node_main.parse_args(cmd[4:])
    assert (args.crypto, args.device, args.crypto_crossover, args.metrics_out) == ("torch", "cuda", 1,
                                                                                    "metrics-2.json")
    assert (args.keys, args.store, args.committee) == (".node-2.json", ".db-2/log", ".committee.json")
    assert not (args.crypto_sharded or args.no_warmup or args.ingress)
    backend_args = argparse.Namespace(crypto="torch", crypto_crossover=1, crypto_sharded=False, device="cpu")
    backend = node_main.make_node_backend(backend_args)
    assert (backend.crossover, backend.committee_crossover, backend.device.type) == (1, 1, "cpu")

    client = chip_smoke.port_client_cmd("py", 9001, ["127.0.0.1:9000", "127.0.0.1:9002"], 4)
    assert client[:3] == ["py", "-m", "hotstuff_tpu_torch.node.client"]
    seen = {}
    with mock.patch.object(node_client.asyncio, "run", lambda coro: (seen.update(client=coro.cr_frame.f_locals),
                                                                    coro.close())), \
            mock.patch.object(node_client, "setup_logging"):
        node_client.main(client[3:])
    local = seen["client"]
    assert local["target"] == ("127.0.0.1", 9001)
    assert (local["size"], local["rate"]) == (chip_smoke.LOCAL_BENCH["tx_size"], chip_smoke.LOCAL_BENCH["rate"] // 4)
    assert local["nodes"] == [("127.0.0.1", 9000), ("127.0.0.1", 9002)]


def _node_dump(tpu_sigs=120, committee_sigs=40, cpu_sigs=0, **launches):
    base = dict.fromkeys(chip_smoke.NODE_KERNELS, 3)
    base.update(dict.fromkeys(("g1_aggregate", "bit_ladder", "field12", "alu_chain"), 0))
    base.update(launches)
    return {"counters": {"crypto.tpu_sigs": tpu_sigs, "verifier.committee_sigs": committee_sigs,
                         "crypto.cpu_sigs": cpu_sigs}, "launches": base}


def test_port_committee_reads_each_nodes_dump(tmp_path):
    """Phase 13 reads each node's `--metrics-out` dump: the lanes of each
    route, and the launches of the node's kernels and of no other."""
    from hotstuff_tpu_torch.node import main as node_main
    from hotstuff_tpu_torch.crypto import batch_service  # noqa: F401  (registers what a node's registry holds)
    from hotstuff_tpu_torch.ops import _build

    assert chip_smoke.NODE_KERNELS == {"h_digits", "decompress_table", "ladder", "compress_eq",
                                       "h_digits_idx", "committee_ladder"}
    assert chip_smoke.node_dump_lanes(_node_dump()) == {"generic": 80, "committee": 40, "host": 0}
    assert chip_smoke.node_dump_errors("node-0", _node_dump()) == []
    assert chip_smoke.node_dump_errors("node-1", _node_dump(committee_sigs=0)) == [
        "node-1: lanes {'generic': 120, 'committee': 0, 'host': 0}"]
    assert chip_smoke.node_dump_errors("node-1", _node_dump(cpu_sigs=2))[0].startswith("node-1: lanes")
    assert chip_smoke.node_dump_errors("node-2", _node_dump(h_digits_idx=0)) == [
        "node-2: ['h_digits_idx'] never launched"]
    bad = chip_smoke.node_dump_errors("node-3", _node_dump(bit_ladder=1, g1_aggregate_affine=2))
    assert len(bad) == 1 and "['bit_ladder', 'g1_aggregate_affine'] launched off the node's path" in bad[0]
    assert chip_smoke.node_dump_errors("node-3", {"counters": {}}) == [
        "node-3: lanes {'generic': 0, 'committee': 0, 'host': 0}", "node-3: the dump holds no launch counts"]
    timings = chip_smoke.node_dump_timings({
        "counters": {"crypto.tpu_batches": 9},
        "histograms": {"consensus.commit_latency_s": {"p50": 0.0125, "p99": 0.5},
                       "crypto.batch_size": {"mean": 12.345}}})
    assert timings == {"consensus.commit_latency_s": (12.5, 500.0), "card_batches": 9, "mean_batch": 12.35}
    # The node's own dump holds what the phase reads.
    path = tmp_path / "metrics.json"
    node_main.write_metrics(str(path))
    dump = json.loads(path.read_text())
    assert set(dump["launches"]) == set(_build.KERNELS)
    assert {"crypto.tpu_sigs", "crypto.cpu_sigs", "verifier.committee_sigs"} <= set(dump["counters"])
    assert set(chip_smoke.NODE_TIMINGS) | {"crypto.batch_size"} <= set(dump["histograms"])


def test_committed_between_counts_commit_lines_in_the_window():
    import calendar

    start = calendar.timegm((2026, 10, 17, 5, 40, 56, 0, 0, 0))
    assert chip_smoke.committed_between(_LOG, start, start + 1) == 2  # the per-payload line is not a block
    assert chip_smoke.committed_between(_LOG, start + 0.15, start + 1) == 1
    assert chip_smoke.committed_between(_LOG, start, start + 0.2) == 1
    assert chip_smoke.committed_between(_LOG, start + 1, start + 2) == 0


def test_committed_txs_counts_each_committed_payload_once():
    ts = "[2026-10-18T03:02:05.324Z INFO hotstuff.{}] "
    author = "\n".join([ts.format("mempool") + "Payload P1= contains 1024 B",
                        ts.format("mempool") + "Payload P2= contains 512 B",
                        ts.format("mempool") + "Payload P1= contains sample tx 3"]) + "\n"
    node0 = author + "\n".join([ts.format("consensus") + "Committed B1(AAAA)",
                                ts.format("consensus") + "Committed B1(AAAA) -> P1=",
                                ts.format("consensus") + "Committed B2(BBBB) -> P1=",
                                ts.format("consensus") + "Committed B2(BBBB) -> P2="]) + "\n"
    node1 = ts.format("consensus") + "Committed B1(AAAA) -> P1=\n" + ts.format("consensus") + "Committed B3(CC) -> P9=\n"
    assert chip_smoke.committed_txs({"node-0": node0, "node-1": node1}, 512) == {"node-0": 3, "node-1": 2}


# --- phase 15: the client ingress and commit proofs -----------------------------


def test_ingress_ports_leave_each_nodes_offsets_free():
    import socket

    avoid = chip_smoke._free_ports(8)
    fronts = chip_smoke.free_ports_with_offsets(4, avoid=avoid)
    taken = set(avoid)
    for p in fronts:
        group = {p, p + chip_smoke.INGRESS_PORT_OFFSET, p + chip_smoke.PROOFS_PORT_OFFSET}
        assert not group & taken
        taken |= group
        for q in group - {p}:
            with socket.socket() as s:
                s.bind(("127.0.0.1", q))


def test_ingress_node_parameters_and_loadgen_command_lines(tmp_path):
    """Phase 15's parameters turn the client plane on over phase 13's, and
    each leg's command line parses under the port's loadgen: leg A with
    proofs and a certificate file, leg B over four processes, each leg's
    clients its own."""
    from hotstuff_tpu_torch import loadgen
    from hotstuff_tpu_torch.node.config import NodeParameters, Secret

    names = [Secret.new().name.encode_base64() for _ in range(4)]
    _, parameters = chip_smoke.write_node_configs(tmp_path, names, list(range(30_000, 30_012)),
                                                  chip_smoke.INGRESS_NODE_PARAMS)
    p = NodeParameters.read(str(parameters))
    assert p.mempool.ingress_enabled and p.mempool.benchmark_mode
    assert (p.mempool.ingress_port_offset, p.mempool.proofs_port_offset) == (
        chip_smoke.INGRESS_PORT_OFFSET, chip_smoke.PROOFS_PORT_OFFSET)
    assert chip_smoke.LOCAL_NODE_PARAMS["mempool"].get("ingress_enabled") is None  # phase 13's are untouched
    a = chip_smoke.loadgen_cmd("py", 9100, "A", "leg-A.json", "proofs-A.jsonl")
    b = chip_smoke.loadgen_cmd("py", 9100, "B", "leg-B.json", "proofs-B.jsonl")
    assert a[:3] == b[:3] == ["py", "-m", "hotstuff_tpu_torch.loadgen"]
    args_a, args_b = loadgen.parse_args(a[3:]), loadgen.parse_args(b[3:])
    assert (args_a.target, args_a.curve, args_a.rate, args_a.duration, args_a.clients, args_a.tx_bytes) == (
        "127.0.0.1:9100", "flash", 100.0, 10.0, 8, 512)
    assert args_a.proofs and args_a.proofs_out == "proofs-A.jsonl" and args_a.procs == 1
    assert (args_a.spike_start, args_a.spike_end) == (10 / 3, 20 / 3)
    assert (args_b.rate, args_b.procs, args_b.proofs, args_b.proofs_out) == (5000.0, 4, False, None)
    assert args_a.seed != args_b.seed


def _leg(offered=10, accepted=6, shed=4, **kw):
    s = {"offered": offered, "accepted": accepted, "shed": shed, "bad_signature": 0, "replay": 0, "malformed": 0,
         "unresolved": 0, "errors": 0}
    s.update(kw)
    return s


def test_loadgen_errors_gate_each_leg():
    assert chip_smoke.loadgen_errors("B", 0, _leg()) == []
    proofs = {"tracked": 6, "served": 6, "verified_ok": 6, "verify_failed": 0}
    assert chip_smoke.loadgen_errors("A", 0, _leg(proofs=proofs)) == []
    assert chip_smoke.loadgen_errors("A", 0, _leg(proofs={**proofs, "served": 5})) == [
        f"leg A: proofs {({**proofs, 'served': 5})} for 6 accepted transactions"]
    assert chip_smoke.loadgen_errors("A", 0, _leg(proofs={**proofs, "verify_failed": 1}))
    errors = chip_smoke.loadgen_errors("B", 2, _leg(offered=12, unresolved=2))
    assert errors == ["leg B: loadgen exited 2", "leg B: 2 unresolved, 0 errors",
                      "leg B: offered 12 != accepted 6 + shed 4 + rejected 0"]
    assert chip_smoke.loadgen_errors("B", 0, _leg(accepted=5, bad_signature=1)) == [
        "leg B: 1 valid signatures answered bad_signature"]
    assert chip_smoke.loadgen_errors("B", 0, _leg(accepted=0, shed=10)) == ["leg B: nothing accepted"]


def test_ingress_dump_errors():
    dump = {"counters": {"ingress.verified_sigs": 64, "ingress.rejected_sigs": 0, "proofs.cert_mismatch": 0},
            "launches": dict.fromkeys(chip_smoke.INGRESS_KERNELS, 2)}
    assert chip_smoke.ingress_dump_errors("node-0", dump, True) == []
    assert chip_smoke.ingress_dump_errors("node-1", {"counters": {}}, False) == []
    bad = {"counters": {"ingress.rejected_sigs": 3, "proofs.cert_mismatch": 1}, "launches": {"ladder": 1}}
    assert chip_smoke.ingress_dump_errors("node-0", bad, True) == [
        "node-0: ingress.rejected_sigs 3", "node-0: proofs.cert_mismatch 1", "node-0: no client signature verified",
        "node-0: ['h_digits', 'decompress_table', 'compress_eq'] never launched"]


def test_committed_txs_in_a_window():
    import calendar

    ts = "[2026-10-18T03:02:0{}.500Z INFO hotstuff.{}] "
    author = ts.format(1, "mempool") + "Payload P1= contains 1024 B\n" + ts.format(1, "mempool") + \
        "Payload P2= contains 512 B\n"
    log = author + "\n".join([ts.format(2, "consensus") + "Committed B1(AA) -> P1=",
                              ts.format(4, "consensus") + "Committed B2(BB) -> P2=",
                              ts.format(4, "consensus") + "Committed B3(CC) -> P1="]) + "\n"
    start = calendar.timegm((2026, 10, 18, 3, 2, 2, 0, 0, 0))
    assert chip_smoke.committed_txs({"n": log}, 512, (start, start + 1)) == {"n": 2}
    assert chip_smoke.committed_txs({"n": log}, 512, (start + 1, start + 3)) == {"n": 3}
    assert chip_smoke.committed_txs({"n": log}, 512, (start, start + 3)) == {"n": 3}
    assert chip_smoke.committed_txs({"n": log}, 512, (start + 3, start + 9)) == {"n": 0}


def test_certificate_verdicts_on_cpu():
    """Leg A's certificates through `CommitProof.verify` on the plain
    kernels and on OpenSSL: equal verdicts, tampered copies rejected."""
    import dataclasses

    from hotstuff_tpu_torch.consensus.config import Committee
    from hotstuff_tpu_torch.consensus.messages import QC, _vote_digest
    from hotstuff_tpu_torch.crypto import Digest, PublicKey, Signature
    from hotstuff_tpu_torch.proofs import CommitProof
    from hotstuff_tpu_torch.utils.serde import Writer

    pairs = sorted(pysigner.keypair_from_seed(bytes([i + 7]) * 32) for i in range(4))
    keys = [(PublicKey(pk), seed) for pk, seed in pairs]
    cmt = Committee.new([(pk, 1, ("127.0.0.1", 1)) for pk, _ in keys])
    skeleton = CommitProof(keys[1][0], 5, (Digest.of(b"payload"),), Digest.of(b"parent"), 4, QC.genesis())
    digest = skeleton.block_digest()
    msg = _vote_digest(digest, 5).data
    proof = dataclasses.replace(skeleton, cert=QC(digest, 5, tuple(
        (pk, Signature(pysigner.sign(seed, msg))) for pk, seed in keys[:3])))
    w = Writer()
    proof.encode(w)
    line = json.dumps({"proof": w.bytes().hex(), "tx": "00"})
    verdicts = chip_smoke.certificate_verdicts([line], cmt, device="cpu")
    assert verdicts["card"] == verdicts["host"] == {
        "certificates": ["ok"], "tampered": ["ProofVerificationError", "InvalidSignatureError"]}


# --- phase 16: the in-process testbed ------------------------------------------


def test_deploy_port_check_names_each_taken_port():
    """The port-free check binds each of the testbed's ports and names the
    ones held; it never moves a port."""
    import socket

    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        port = held.getsockname()[1]
        bases = (port - 2, port + 100, port + 200)
        taken = chip_smoke.deploy_ports_taken(4, bases)
        assert port in taken and all(p == port for p in taken)
    assert chip_smoke.deploy_ports_taken(4, bases) == []
    assert chip_smoke.DEPLOY_BASES == (7000, 7100, 7200)


def _deploy_log(rows) -> str:
    """Commit lines of a deploy log: rows of (round, digest, times)."""
    return "".join(f"[2026-01-01T00:00:{r:02d}.000Z INFO hotstuff.consensus] Committed B{r}({d})\n"
                   f"[2026-01-01T00:00:{r:02d}.000Z INFO hotstuff.consensus] Committed B{r}({d}) -> p{r}\n" * k
                   for r, d, k in rows)


@pytest.mark.parametrize("rows, errors", [
    ([(1, "a", 4), (2, "b", 4), (3, "c", 2)], []),
    ([(1, "a", 4), (3, "c", 4)], []),
    ([(1, "a", 4), (2, "b", 3), (3, "c", 4)], ["rounds [2] are not committed by all 4 nodes, though round 3 is"]),
    ([(1, "a", 4), (1, "x", 1)], ["round 1: digests ['a', 'x']", "no round committed by all 4 nodes"]),
    ([(1, "a", 5)], ["round 1: a committed 5 times by 4 nodes", "no round committed by all 4 nodes"]),
    ([(1, "a", 3)], ["no round committed by all 4 nodes"]),
], ids=["tail cut", "a skipped round", "a short round", "two digests", "five commits", "none full"])
def test_deploy_counts_each_digests_four_commits(rows, errors):
    counts = chip_smoke.deploy_commit_counts(_deploy_log(rows))
    want = {}
    for r, d, k in rows:
        want.setdefault(r, {})[d] = want.get(r, {}).get(d, 0) + k
    assert counts == want
    assert chip_smoke.deploy_commit_errors(counts, 4) == errors


def test_deploy_widths_and_dump_errors():
    assert chip_smoke.deploy_widths(1) == chip_smoke.deploy_widths(128) == [128]
    assert chip_smoke.deploy_widths(129) == [128, 256]
    assert chip_smoke.deploy_widths(100_000) == [128, 256, 512, 1024, 2048, 4096]
    launches = {name: 0 for name in chip_smoke.REPLACES}
    launches.update({name: 3034 for name in chip_smoke.DEPLOY_KERNELS})
    dump = {"counters": {"crypto.tpu_sigs": 5919}, "launches": launches,
            "histograms": {"verifier.batch_size": {"max": 4}}}
    assert chip_smoke.deploy_dump_errors(dump) == []
    assert chip_smoke.deploy_launches(dump) == launches
    bad = {"counters": {"crypto.tpu_sigs": 10, "verifier.committee_sigs": 2, "crypto.cpu_sigs": 1},
           "launches": {**launches, "ladder": 0, "committee_ladder": 2}}
    assert chip_smoke.deploy_dump_errors(bad) == [
        "lanes {'generic': 8, 'committee': 2, 'host': 1} (want generic > 0, committee 0, host 0)",
        "['ladder'] never launched", f"['committee_ladder'] launched off deploy's path: {bad['launches']}"]
    assert chip_smoke.deploy_dump_errors({"counters": {"crypto.tpu_sigs": 1}}) == ["the dump holds no launch counts"]


def test_deploy_launches_ride_every_row_of_the_kernels_line():
    """Each row of the kernels line carries `deploy_launches`, read from
    phase 16's dump (0 for a kernel off deploy's path)."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert src.count("deploy_launches=port_deploy[\"launches\"].get(") == src.count("ingress_node_launches=")
    assert "phase_port_deploy(" in src
    cmd = chip_smoke.deploy_cmd("py", "m.json")
    assert cmd[2:] == ["hotstuff_tpu_torch.node.main", "-vv", "deploy", "--nodes", "4", "--crypto-crossover", "1",
                       "--metrics-out", "m.json"]


def test_laps_split_the_run_by_phase(monkeypatch):
    """`Laps` closes each stretch at its lap, and `main` laps every phase
    it runs, from the build to phase 16, before the kernels line."""
    import inspect

    clock = iter([10.0, 12.5, 12.5, 20.04])
    monkeypatch.setattr(chip_smoke.time, "perf_counter", lambda: next(clock))
    laps = chip_smoke.Laps()
    laps.lap("1 build")
    laps.lap("2 compare")
    laps.lap("3 main path")
    assert laps.seconds == {"1 build": 2.5, "2 compare": 0.0, "3 main path": 7.5}
    src = inspect.getsource(chip_smoke.main)
    labels = re.findall(r'laps\.lap\("([^"]+)"\)', src)
    assert labels[0] == "1 build" and labels[-1] == "16 port deploy" and len(labels) == len(set(labels)) == 16
    assert src.index("phase seconds:") < src.index('json.dumps({"kernels": rows})')


def test_port_committee_traces_each_node_and_reads_its_watchdog(tmp_path):
    """Phase 13's nodes run with `--trace-out`; `node_watchdog` reads the
    baseline the port's watchdog logs, its triggers and the auto-dumps
    written beside the trace file."""
    import logging

    from hotstuff_tpu_torch.node import main as node_main
    from hotstuff_tpu_torch.utils import tracing

    cmd = chip_smoke.port_node_cmd("py", 1, ".c.json", ".p.json", "metrics-1.json", 9100, "trace-1.json")
    args = node_main.parse_args(cmd[4:])
    assert (args.telemetry_port, args.trace_out, args.metrics_out) == (9100, "trace-1.json", "metrics-1.json")
    assert "--trace-out" not in chip_smoke.port_node_cmd("py", 1, ".c.json", ".p.json", "m.json")

    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(f"[t INFO {record.name}] {record.getMessage()}")
    logger = logging.getLogger("hotstuff.tracing")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    was = tracing.enabled()
    tracing.enable(True)
    try:
        wd = tracing.AnomalyWatchdog(p99_factor=4.0, cooldown_s=0.0)
        for _ in range(wd.BASELINE_SAMPLES):
            wd.note_verify(0.0025, 1000)
        for _ in range(wd.REGRESSION_STREAK):
            wd.note_verify(0.1, 1000)
    finally:
        tracing.enable(was)
        logger.removeHandler(handler)
        logger.setLevel(level)
    (tmp_path / "trace-1.json.watchdog-verify_regression-1.json").write_text("{}")
    (tmp_path / "trace-2.json.watchdog-slo_burn-1.json").write_text("{}")
    log = "\n".join(records + ["[t WARNING hotstuff.tracing] anomaly watchdog fired: slo_burn {}"])
    assert chip_smoke.node_watchdog(tmp_path, "trace-1.json", log) == dict(
        baseline_us=2.5, verify_regression=1, triggers={"slo_burn": 1, "verify_regression": 1},
        dumps=["trace-1.json.watchdog-verify_regression-1.json"])
    assert chip_smoke.node_watchdog(tmp_path, "trace-3.json", "") == dict(
        baseline_us=None, verify_regression=0, triggers={}, dumps=[])


def test_phase_watchdog_on_cpu(monkeypatch, capsys):
    """The forced watchdog check's control flow at 64 lanes: a plain-kernel
    `TorchBackend` whose verifier answers OpenSSL's mask at once stands in
    for the card, so the OpenSSL stretch's flushes cost far more a
    signature than the baseline and the watchdog fires once, on the last."""
    pytest.importorskip("cryptography")
    import numpy as np

    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend

    M, K, S, want = chip_smoke.watchdog_corpus(0, 64)
    assert len(set(zip(M, K, S))) == 64 and want.count(False) == 4
    backend = TorchBackend(device="cpu", crossover=1)
    monkeypatch.setattr(backend._verifier, "verify_batch_mask", lambda *a: np.array(want))
    out = chip_smoke.phase_watchdog(0, device="cpu", backend=backend, lanes=64)
    assert out["fired_at"] == chip_smoke.WATCHDOG_CARD_FLUSHES + chip_smoke.WATCHDOG_HOST_FLUSHES - 1
    assert out["trigger_us"] > 4 * out["baseline_us"]
    assert backend.stats["device_batches"] == chip_smoke.WATCHDOG_CARD_FLUSHES + 1
    assert backend.stats["host_batches"] == chip_smoke.WATCHDOG_HOST_FLUSHES
    assert "verify_regression fired once" in capsys.readouterr().out
    monkeypatch.setattr(backend._verifier, "verify_batch_mask", lambda *a: ~np.array(want))
    backend.crossover = 1
    with pytest.raises(SystemExit, match="masks differ from OpenSSL's"):
        chip_smoke.phase_watchdog(0, device="cpu", backend=backend, lanes=64)


def test_sidecar_reports_watchdog_triggers_beside_its_lanes():
    """Phases 6 and 7: a `verify_regression` warning of the sidecar's
    process lands in `watchdog` with its details and is printed with the
    baseline and the phase's lanes; any other warning still lands in
    `errors`."""
    import logging

    from hotstuff_tpu_torch.crypto.pysigner import PurePythonBackend

    sidecar = chip_smoke._Sidecar(PurePythonBackend())
    try:
        logging.getLogger("hotstuff.tracing").warning(
            "anomaly watchdog fired: %s %s", "verify_regression", {"per_sig_s": 1.5e-05, "baseline_s": 2.25e-06})
        logging.getLogger("hotstuff.remote").warning("something else")
    finally:
        sidecar.stop()
    assert sidecar.watchdog == [{"per_sig_s": 1.5e-05, "baseline_s": 2.25e-06}]
    assert sidecar.errors == ["hotstuff.remote: something else"]
    line = sidecar.watchdog_line("sidecar", 4096, 0)
    assert line.startswith("sidecar watchdog: verify baseline ")
    assert line.endswith("us a signature; verify_regression fired 1 times (15.000 against 2.250 us); "
                         "4096 lanes on the card, 0 on the host")


def test_tracing_ab_runs_phase_13_in_turns(monkeypatch, capsys):
    """`--tracing-ab`: phase 13 under each tracing mode, in the turns off,
    on, dump, dump, on, off, each in a run directory of its own; each
    mode's rates are printed and the last line holds them all."""
    seen = []

    def fake(run_dir, tracing):
        seen.append((run_dir.name, tracing))
        return {"tx_per_s": 900.0 + len(seen), "commits_per_s": 30.0 + len(seen)}

    monkeypatch.setattr(chip_smoke, "phase_port_committee", fake)
    assert chip_smoke.tracing_ab("NVIDIA H100 80GB HBM3, 700.00 W") == 0
    assert seen == [(f"tracing_ab_{i}", m) for i, m in enumerate(("off", "on", "dump", "dump", "on", "off"))]
    out = capsys.readouterr().out.splitlines()
    assert "tracing dump: tx/s [903.0, 904.0], blocks a second a node [33.0, 34.0], means 903.500 and 33.5000" in out
    assert json.loads(out[-1]) == {"tracing_ab": {"dump": [[903.0, 33.0], [904.0, 34.0]],
                                                  "on": [[902.0, 32.0], [905.0, 35.0]],
                                                  "off": [[901.0, 31.0], [906.0, 36.0]]}}
