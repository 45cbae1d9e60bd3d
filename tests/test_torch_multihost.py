"""The port's multi-process mesh (`hotstuff_tpu_torch.parallel.init_multihost`)
and the sidecar's `--multihost`, in two real processes on the CPU.

The counterpart of tests/test_multihost.py: two ranks join over gloo on
127.0.0.1, each with a virtual mesh of 2 CPU shards, so the global mesh has
the reference test's 2 x 2 entries, and run the sharded verifier over it on
the generic path, the committee path and `packed=False`. The batch and the
expected mask are the reference test's (`__graft_entry__._signed_batch(16,
seed=3)` with lane 5 zeroed), held here against the reference's OpenSSL
`CpuBackend` too. The workers import neither JAX nor the JAX package, and
are killed at a bounded `communicate` timeout, as the reference test's are.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from hotstuff_tpu_torch.crypto import remote
from tests.common_torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytest.importorskip("cryptography")

from __graft_entry__ import _signed_batch  # noqa: E402
from hotstuff_tpu.crypto.backend import CpuBackend as RefCpuBackend  # noqa: E402
from hotstuff_tpu.crypto.primitives import PublicKey as RefPublicKey  # noqa: E402
from hotstuff_tpu.crypto.primitives import Signature as RefSignature  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 120

WORKER = r"""
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from hotstuff_tpu_torch.parallel import ShardedEd25519TorchVerifier, init_multihost
from hotstuff_tpu_torch.utils import metrics

batch = json.load(open(sys.argv[1]))
msgs, pks, sigs = ([bytes.fromhex(x) for x in batch[k]] for k in ("msgs", "pks", "sigs"))
mesh = init_multihost(device="cpu", local_shards=2)
assert mesh.size == 4 and mesh.ranks == (0, 0, 1, 1), mesh
gathers = metrics.counter("mesh.gathers")
out = {{"rank": mesh.rank}}
for packed in (True, False):
    v = ShardedEd25519TorchVerifier(mesh=mesh, packed=packed)
    assert v._defer_readback and v.pipeline.depth == 1 and v.mesh_alignment == 512
    g0 = gathers.value
    out["generic" if packed else "unpacked"] = v.verify_batch_mask(msgs, pks, sigs).tolist()
    out["gathers_" + ("generic" if packed else "unpacked")] = gathers.value - g0
    if packed:
        table = v.set_committee(sorted(set(pks)))
        assert list(table.replicas) == [torch.device("cpu")]
        g0 = gathers.value
        out["committee"] = v.verify_batch_mask_committee(msgs, [table.index[k] for k in pks], sigs).tolist()
        out["gathers_committee"] = gathers.value - g0
    v.close()
assert not {{"jax", "hotstuff_tpu"}} & set(sys.modules), "the worker imported JAX or the JAX package"
print("MULTIHOST " + json.dumps(out), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, port: int) -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE="2", RANK=str(rank), OMP_NUM_THREADS="1")


def _batch(seed: int):
    msgs, pks, sigs = _signed_batch(16, seed=seed)
    sigs[5] = bytes(64)
    want = [True] * 16
    want[5] = False
    return msgs, pks, sigs, want


def _openssl(msgs, pks, sigs) -> list[bool]:
    return RefCpuBackend().verify_batch_mask(msgs, [RefPublicKey(k) for k in pks], [RefSignature(s) for s in sigs])


def test_two_process_mesh_verify(tmp_path):
    """Two gloo ranks x 2 CPU shards: the generic, committee and
    `packed=False` masks on both ranks are the reference test's expected
    mask and OpenSSL's, exactly, each from one gather a batch."""
    msgs, pks, sigs, want = _batch(3)
    assert _openssl(msgs, pks, sigs) == want
    inputs = tmp_path / "batch.json"
    inputs.write_text(json.dumps({"msgs": [m.hex() for m in msgs], "pks": [k.hex() for k in pks],
                                  "sigs": [s.hex() for s in sigs]}))
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=str(REPO)))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(script), str(inputs)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=_rank_env(r, port), cwd=tmp_path) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:  # a hung collective must not leak workers
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        line = next(ln for ln in out.splitlines() if ln.startswith("MULTIHOST "))
        results.append(json.loads(line.removeprefix("MULTIHOST ")))
    for r, res in enumerate(results):
        assert res["rank"] == r
        for path in ("generic", "committee", "unpacked"):
            assert res[path] == want, (r, path, res[path])
            assert res[f"gathers_{path}"] == 1, (r, path)


def _boot(procs_logs, deadline_s: float = 90.0) -> list[int]:
    """Wait until every sidecar prints its readiness line; their ports."""
    deadline = time.monotonic() + deadline_s
    ports = []
    for proc, log in procs_logs:
        while "successfully booted" not in log.read_text():
            assert proc.poll() is None, log.read_text()[-3000:]
            assert time.monotonic() < deadline, log.read_text()[-3000:]
            time.sleep(0.2)
        line = next(ln for ln in log.read_text().splitlines() if "successfully booted" in ln)
        ports.append(int(line.rsplit(":", 1)[1]))
    return ports


def test_two_multihost_sidecars_answer_alike(tmp_path):
    """Two `--multihost --device cpu --no-warmup` sidecars of one job, each
    sent the same requests in lock step over TCP (a genuine batch, then a
    forged one), answer the same bytes: the expected masks."""
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature

    port = _free_port()
    procs_logs = []
    try:
        for r in range(2):
            log = tmp_path / f"sidecar{r}.log"
            with open(log, "w") as out:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "hotstuff_tpu_torch.crypto.remote", "-vv", "--port", "0",
                     "--device", "cpu", "--no-warmup", "--multihost"],
                    cwd=tmp_path, env=_rank_env(r, port), stdout=subprocess.DEVNULL, stderr=out,
                    start_new_session=True)
            procs_logs.append((proc, log))
        ports = _boot(procs_logs)
        clients = [remote.RemoteBackend(("127.0.0.1", p), crossover=1) for p in ports]
        genuine = _batch(3)
        msgs, pks, sigs, _ = _batch(4)
        sigs[9] = sigs[9][:40] + bytes([sigs[9][40] ^ 1]) + sigs[9][41:]
        forged = (msgs, pks, sigs, _openssl(msgs, pks, sigs))
        assert forged[3].count(False) == 2
        for msgs, pks, sigs, want in (genuine, forged):
            args = (msgs, [PublicKey(k) for k in pks], [Signature(s) for s in sigs])
            answers = [None, None]

            def ask(i):
                answers[i] = clients[i].verify_batch_mask(*args)

            threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WORKER_TIMEOUT_S)
            assert answers[0] == answers[1] == want
        for c in clients:
            assert c.stats["remote_sigs"] == 32 and c.stats["cpu_sigs"] == 0, c.stats
            c.close()
    finally:
        for proc, _ in procs_logs:
            proc.kill()
            proc.wait(timeout=30)
    for _, log in procs_logs:
        assert "batches split over DeviceMesh" in log.read_text()


def test_sidecar_refuses_multihost_with_sharded(capsys):
    """`--sharded` splits over this process's GPUs alone: refused beside
    `--multihost`, as the reference refuses `--multihost` without
    `--backend tpu`."""
    with pytest.raises(SystemExit) as exc:
        remote.main(["--port", "0", "--multihost", "--sharded"])
    assert exc.value.code == 2
    assert "--multihost" in capsys.readouterr().err
