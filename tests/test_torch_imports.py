"""Package rules of the PyTorch/CUDA port: it imports neither jax nor any
module of hotstuff_tpu, it reads nothing of the reference's native plane
(`native/`), it never carries on silently on the CPU, and a kernel wrapper
given a non-CPU tensor launches its kernel or raises."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import hotstuff_tpu_torch
from hotstuff_tpu_torch import resolve_device
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from hotstuff_tpu_torch import tune_device
from hotstuff_tpu_torch.ops import _build, bit_ladder, bls, committee, field, field12, ladder, sha512
from hotstuff_tpu_torch.ops import ed25519 as ted

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import hotstuff_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hotstuff_tpu_torch.__path__, "hotstuff_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import tempfile
from hotstuff_tpu_torch.node import main as node_main
with tempfile.TemporaryDirectory() as tmp:
    node_main.main(["keys", "--filename", tmp + "/key.json"])
from hotstuff_tpu_torch.utils import telemetry
telemetry.default_slos()  # its lazy import of the scheduler
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "hotstuff_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("hotstuff_tpu_torch.ops.field", "hotstuff_tpu_torch.ops.verifier",
                "hotstuff_tpu_torch.ops.committee", "hotstuff_tpu_torch.crypto.torch_backend",
                "hotstuff_tpu_torch.convert", "hotstuff_tpu_torch.crypto.remote",
                "hotstuff_tpu_torch.crypto.batch_service", "hotstuff_tpu_torch.crypto.scheduler",
                "hotstuff_tpu_torch.node.config", "hotstuff_tpu_torch.utils.metrics",
                "hotstuff_tpu_torch.utils.actors", "hotstuff_tpu_torch.utils.logging",
                "hotstuff_tpu_torch.ops.pipeline", "hotstuff_tpu_torch.ops.timeline",
                "hotstuff_tpu_torch.parallel", "hotstuff_tpu_torch.parallel.mesh",
                "hotstuff_tpu_torch.crypto.native_staging", "hotstuff_tpu_torch.ops.bls",
                "hotstuff_tpu_torch.crypto.aggsig", "hotstuff_tpu_torch.ops.bit_ladder",
                "hotstuff_tpu_torch.ops.field12", "hotstuff_tpu_torch.tune_device",
                "hotstuff_tpu_torch.bench", "hotstuff_tpu_torch.utils.serde", "hotstuff_tpu_torch.utils.tracing",
                "hotstuff_tpu_torch.utils.telemetry", "hotstuff_tpu_torch.latch_probe", "hotstuff_tpu_torch.roofline",
                "hotstuff_tpu_torch.consensus", "hotstuff_tpu_torch.consensus.messages",
                "hotstuff_tpu_torch.ingress", "hotstuff_tpu_torch.ingress.messages",
                "hotstuff_tpu_torch.ingress.admission", "hotstuff_tpu_torch.ingress.loadgen",
                "hotstuff_tpu_torch.ingress.pipeline", "hotstuff_tpu_torch.ingress.server",
                "hotstuff_tpu_torch.proofs", "hotstuff_tpu_torch.proofs.messages", "hotstuff_tpu_torch.proofs.registry",
                "hotstuff_tpu_torch.proofs.server", "hotstuff_tpu_torch.loadgen", "hotstuff_tpu_torch.crypto.primitives",
                "hotstuff_tpu_torch.crypto.service", "hotstuff_tpu_torch.network",
                "hotstuff_tpu_torch.network.net", "hotstuff_tpu_torch.store", "hotstuff_tpu_torch.store.store",
                *(f"hotstuff_tpu_torch.consensus.{m}" for m in (
                    "config", "errors", "reconfig", "leader", "mempool_driver", "aggregator", "overlay",
                    "synchronizer", "core", "consensus")),
                "hotstuff_tpu_torch.mempool",
                *(f"hotstuff_tpu_torch.mempool.{m}" for m in (
                    "config", "errors", "messages", "payload_maker", "front", "synchronizer", "core", "mempool")),
                "hotstuff_tpu_torch.node", "hotstuff_tpu_torch.node.node", "hotstuff_tpu_torch.node.client",
                "hotstuff_tpu_torch.node.main", "hotstuff_tpu_torch.crypto.pysigner",
                "hotstuff_tpu_torch.chaos", "hotstuff_tpu_torch.chaos_run", "hotstuff_tpu_torch.utils.incidents",
                *(f"hotstuff_tpu_torch.chaos.{m}" for m in (
                    "vtime", "plan", "trusted_crypto", "transport", "byzantine", "invariants", "orchestrator",
                    "scenarios"))):
        assert mod in res["modules"]


def test_no_gpu_means_raise_not_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_wrappers_refuse_non_cpu_tensors_they_cannot_launch():
    """A tensor off the CPU goes to the kernel path, which checks it and
    raises — it never drops to the plain version."""
    meta = lambda *shape, dtype=torch.uint8: torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        sha512.h_digits(meta(32, 8), meta(32, 8), meta(32, 8))
    with pytest.raises(ValueError, match="expected a tensor on"):
        ted.decompress_table(meta(32, 8))
    with pytest.raises(ValueError, match="expected a tensor on"):
        ladder.ladder(meta(64, 8), meta(64, 8), meta(4, 16, 10, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected a tensor on"):
        ted.compress_eq(meta(4, 10, 8, dtype=torch.int32), meta(32, 8), meta(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="expected a tensor on"):
        sha512.h_digits_gather(meta(32, 8), meta(32, 3), meta(8, dtype=torch.int32), meta(32, 8))
    table = ted.CommitteeTable([bytes(32)] * 3, device="cpu")  # tables on the CPU, digits elsewhere
    with pytest.raises(ValueError, match="expected a tensor on"):
        committee.committee_ladder(meta(64, 8), meta(64, 8), table, meta(8, dtype=torch.int32))
    assert _build.launches() == {name: 0 for name in _build.KERNELS}


def test_bls_table_has_no_host_fallback(monkeypatch):
    """Without a card, a `CommitteeTable` that asks for one (the default)
    raises, where the reference's degrades to its exact-integer host fold;
    a table given `device="cpu"` runs the plain version. A mask off the CPU
    goes to kernel K6's checks, never to the plain version or a fold."""
    keys = [bls.aggsig.ExactBlsScheme().keypair_from_seed(b"\x01" * 32)[0]] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bls.CommitteeTable(keys)
    assert bls.CommitteeTable(keys, device="cpu").aggregate_bitmaps([0b11])[0] is not None
    meta = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="expected a tensor on"):
        bls.g1_aggregate(meta(12, 2), meta(12, 2), meta(2, dtype=torch.bool), meta(4, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="expected a tensor on"):
        bls.g1_aggregate_affine(meta(12, 2), meta(12, 2), meta(2, dtype=torch.bool), meta(4, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="expected a tensor on"):
        bls.mont_mul_device(meta(12, 4), meta(12, 4))
    assert _build.launches() == {name: 0 for name in _build.KERNELS}


def test_ed25519_committee_table_asks_for_the_card(monkeypatch):
    """The ed25519 `CommitteeTable` is placed as every entry point is: on
    the card unless `device="cpu"` is asked for, so without a card the
    default raises, as the BLS table's does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ted.CommitteeTable([bytes(32)] * 3)
    assert ted.CommitteeTable([bytes(32)] * 3, device="cpu").entries.device.type == "cpu"


def test_bits_verifier_on_the_card_without_one_raises(monkeypatch):
    """`kernel="bits"` (the f32-argument path) asked for the card on a host
    without one raises, single-device and on a mesh; it never runs on the
    CPU unless asked to."""
    from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier
    from hotstuff_tpu_torch.parallel import ShardedEd25519TorchVerifier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Ed25519TorchVerifier(kernel="bits"),
                 lambda: Ed25519TorchVerifier(device="cuda", kernel="bits", packed=False),
                 lambda: ShardedEd25519TorchVerifier(kernel="bits", packed=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    v = Ed25519TorchVerifier(device="cpu", kernel="bits")
    assert v.device == torch.device("cpu") and not v.packed
    v.close()


def test_bit_ladder_off_the_cpu_launches_k7_never_the_plain_version(monkeypatch):
    """A non-CPU tensor goes to K7's checks and launch (both stubbed here:
    there is no card), never to `bit_ladder_plain`; `verify_args(...,
    "bits")` reaches K7, not K1; the plain version refuses nothing."""
    def plain(*a):
        raise AssertionError("plain version called for a non-CPU tensor")

    launched = []
    monkeypatch.setattr(bit_ladder, "bit_ladder_plain", plain)
    monkeypatch.setattr(_build, "check", lambda t, shape, dtype, dev: launched.append(("check", tuple(shape))))
    monkeypatch.setattr(_build.KERNELS["bit_ladder"], "launch",
                        lambda *a: launched.append(("launch", tuple(a[-2].shape), a[-1])))
    meta = lambda *shape, dtype=torch.uint8: torch.empty(shape, dtype=dtype, device="meta")
    out = bit_ladder.bit_ladder(meta(253, 8), meta(253, 8), meta(4, 16, 10, 8, dtype=torch.int32))
    assert out.device.type == "meta" and out.shape == (4, 10, 8) and out.dtype == torch.int32
    assert launched == [("check", (253, 8)), ("check", (253, 8)), ("check", (4, 16, 10, 8)),
                        ("launch", (4, 10, 8), 8)]
    calls = []
    monkeypatch.setattr(ladder, "bit_ladder", lambda *a: calls.append("K7") or meta(4, 10, 8, dtype=torch.int32))
    monkeypatch.setattr(ladder, "ladder", lambda *a: calls.append("K1") or meta(4, 10, 8, dtype=torch.int32))
    monkeypatch.setattr(ted, "decompress_table", lambda a: (calls.append("K3") or meta(4, 16, 10, 8, dtype=torch.int32),
                                                            meta(8, dtype=torch.bool)))
    monkeypatch.setattr(ted, "compress_eq", lambda *a: calls.append("K4") or meta(8, dtype=torch.bool))
    ladder.verify_args(meta(32, 8), meta(8), meta(32, 8), meta(253, 8), meta(253, 8), kernel="bits")
    ladder.verify_args(meta(32, 8), meta(8), meta(32, 8), meta(64, 8), meta(64, 8), kernel="pallas")
    assert calls == ["K3", "K7", "K4", "K3", "K1", "K4"]


def test_field12_off_the_cpu_launches_k8_never_the_plain_version(monkeypatch):
    """A non-CPU tensor goes to K8's checks and launch (stubbed here: there
    is no card), never to a plain version; unstubbed, the checks refuse a
    tensor on a device that is not a card. The tuning tool's two kernels
    (`field.sqr_chain`, `tune_device.alu_chain`) do the same."""
    meta = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device="meta")
    for wrapper, args in ((field12.mul, (meta(22, 8), meta(22, 8))), (field12.sub, (meta(22, 8), meta(22, 8))),
                          (field12.canonical, (meta(22, 8),)), (field12.sqr_n, (meta(22, 8), 64)),
                          (field.sqr_chain, (meta(10, 8), 64)), (tune_device.alu_chain, (meta(64, 8), 1, 64))):
        with pytest.raises(ValueError, match="expected a tensor on"):
            wrapper(*args)

    def plain(*a):
        raise AssertionError("plain version called for a non-CPU tensor")

    for name in ("mul_plain", "sub_plain", "canonical_plain", "sqr_n_plain", "sqr_plain"):
        monkeypatch.setattr(field12, name, plain)
    monkeypatch.setattr(field, "sqr_n", plain)
    monkeypatch.setattr(tune_device, "alu_chain_plain", plain)
    launched = []
    monkeypatch.setattr(_build, "check", lambda t, shape, dtype, dev: launched.append(("check", tuple(shape), dtype)))
    for name in ("field12", "field12_mul", "field12_sub", "field12_canonical", "field_sqr_n", "alu_chain"):
        monkeypatch.setattr(_build.KERNELS[name], "launch",
                            lambda *a, name=name: launched.append((name, *(x for x in a if isinstance(x, int)))))
    a, b = meta(22, 8), meta(22, 8)
    for out in (field12.mul(a, b), field12.sub(a, b), field12.canonical(a), field12.sqr_n(a, 64), field12.sqr(a)):
        assert out.device.type == "meta" and out.shape == (22, 8) and out.dtype == torch.int32
    assert field.sqr_chain(meta(10, 8), 64).shape == (10, 8)
    assert tune_device.alu_chain(meta(64, 8, dtype=torch.float32), 0, 64).dtype == torch.float32
    i32 = ("check", (22, 8), torch.int32)
    assert launched == [i32, i32, ("field12_mul", 8), i32, i32, ("field12_sub", 8), i32, ("field12_canonical", 8),
                        i32, ("field12", 64, 8), i32, ("field12", 1, 8),
                        ("check", (10, 8), torch.int32), ("field_sqr_n", 64, 8),
                        ("check", (64, 8), torch.float32), ("alu_chain", 0, 64, 512)]


def test_check_rejects_bad_tensors():
    dev = torch.device("cuda", 0)
    t = torch.empty((4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        _build.check(t, (4, 4), torch.uint8, dev)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "no-such-nvcc"))
    assert not hotstuff_tpu_torch.kernels_built()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not hotstuff_tpu_torch.kernels_built()


def test_sources_and_kernels_listed():
    csrc = sorted(p.name for p in _build.CSRC.iterdir())
    assert csrc == sorted(["carry.cuh", "field.cuh", "quad.cuh", "split_field.cuh"] + [f"{n}.cu" for n in _build.NAMES])
    assert {"field12.cu", "field_sqr_n.cu", "alu_chain.cu"} <= set(csrc)
    for name in ("field12", "field12_mul", "field12_sub", "field12_canonical"):
        assert _build.KERNELS[name].source == "field12"
        assert f"extern \"C\" int hs_{name}(" in (_build.CSRC / "field12.cu").read_text()
    for name in ("g1_aggregate", "g1_aggregate_affine", "bls_mont_mul"):
        assert _build.KERNELS[name].source == "g1_aggregate"
        assert f"extern \"C\" int hs_{name}(" in (_build.CSRC / "g1_aggregate.cu").read_text()
    assert _build.KERNELS["field_sqr_n"].source == "field_sqr_n" and _build.KERNELS["alu_chain"].source == "alu_chain"
    assert len(_build.source_hash()) == 16


_NATIVE_PROBE = """
import json, sys
from pathlib import Path
events = []

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        events.append(["open", str(args[0])])
    elif event == "subprocess.Popen":
        events.append(["compile", [str(a) for a in args[1]]])
    elif event == "ctypes.dlopen":
        events.append(["load", str(args[0])])

sys.addaudithook(hook)
from hotstuff_tpu_torch.crypto import native_staging as ns
from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier
Ed25519TorchVerifier(device="cpu")
default = str(ns.library_path())
ns.BUILD, ns._lib = Path(sys.argv[1]), None
ns.load()  # a fresh build of the same source, seen by the hook
print(json.dumps({"events": events, "default": default}))
"""


def test_native_plane_is_the_ports_own(tmp_path):
    """The port's staging library is built from sources under
    hotstuff_tpu_torch/ only, loaded from hotstuff_tpu_torch/native/build/,
    and no file of the reference's native/ is opened (audit hooks on open,
    the compiler's command and dlopen, in a fresh process)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _NATIVE_PROBE, str(tmp_path)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    port, reference = REPO / "hotstuff_tpu_torch", REPO / "native"
    loads = [Path(p) for kind, p in res["events"] if kind == "load" and p != "None"]
    assert Path(res["default"]).is_relative_to(port / "native" / "build")
    staging = [p for p in loads if p.name == "libstaging.so"]
    assert staging[0] == Path(res["default"]) and staging[1].is_relative_to(tmp_path) and len(staging) == 2
    assert not [p for p in loads if p.resolve().is_relative_to(reference)]
    compiles = [cmd for kind, cmd in res["events"] if kind == "compile"]
    assert len(compiles) == 1
    sources = [Path(a) for a in compiles[0] if a.endswith((".cpp", ".cc", ".h", ".hpp"))]
    assert sources == [port / "native" / "staging.cpp"]
    assert not any(a.startswith("-I") for a in compiles[0])
    assert "#include \"" not in sources[0].read_text()  # system headers only
    opened = [Path(p) for kind, p in res["events"] if kind == "open"]
    assert not [p for p in opened if p.resolve().is_relative_to(reference)]
