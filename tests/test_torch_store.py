"""The port's store (`hotstuff_tpu_torch/store/store.py` over its own C++
engine, `hotstuff_tpu_torch/native/store.cpp`) against the reference's
(`hotstuff_tpu/store/store.py`: the reference's C++ engine and its
pure-Python log engine).

The same seeded writes give byte-equal logs; each engine replays the
others' logs, torn tail included, before and after compaction; the
actor's read, write and notify_read behave as the reference's; and a
file-backed store whose engine cannot be built raises instead of falling
back.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

from hotstuff_tpu.store import store as r_store
from hotstuff_tpu_torch.crypto import native_staging
from hotstuff_tpu_torch.store import Store
from hotstuff_tpu_torch.store import store as p_store
from tests.common_torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEED = 404


def _writes(n: int = 300) -> list[tuple[bytes, bytes]]:
    """Seeded writes: keys drawn from a small pool (so most are
    overwritten), values of 0 to 600 bytes."""
    rng = np.random.default_rng(SEED)
    keys = [rng.integers(0, 256, int(k), np.uint8).tobytes() for k in rng.integers(1, 40, 48)]
    return [(keys[int(rng.integers(0, len(keys)))], rng.integers(0, 256, int(rng.integers(0, 600)), np.uint8).tobytes())
            for _ in range(n)]


def _live(writes) -> dict[bytes, bytes]:
    return dict(writes)


def _ref_native(path: str):
    from hotstuff_tpu.crypto import native_staging as r_native

    lib = r_native.get_lib()
    if lib is None or not hasattr(lib, "hs_store_open"):
        pytest.skip("the reference's native library does not build here")
    return r_store._NativeEngine(lib, path)


ENGINES = {
    "port": lambda path: p_store._NativeEngine(p_store._load_library(), path),
    "ref_native": _ref_native,
    "ref_python": r_store._PyLogEngine,
}


def _fill(engine, writes) -> None:
    for k, v in writes:
        engine.put(k, v)


def _assert_holds(engine, live: dict[bytes, bytes]) -> None:
    for k, v in live.items():
        assert engine.get(k) == v
    assert engine.get(b"never written") is None


@pytest.mark.parametrize("other", ["ref_native", "ref_python"])
def test_same_writes_give_the_same_log(tmp_path, other):
    writes = _writes()
    ours, theirs = ENGINES["port"](str(tmp_path / "port.log")), ENGINES[other](str(tmp_path / "ref.log"))
    _fill(ours, writes)
    _fill(theirs, writes)
    assert ours.log_bytes == theirs.log_bytes
    ours.close()
    theirs.close()
    assert (tmp_path / "port.log").read_bytes() == (tmp_path / "ref.log").read_bytes()


@pytest.mark.parametrize("writer, reader", [("port", "ref_native"), ("port", "ref_python"),
                                            ("ref_native", "port"), ("ref_python", "port")])
@pytest.mark.parametrize("compacted", [False, True])
def test_each_engine_replays_the_others_log(tmp_path, writer, reader, compacted):
    writes = _writes()
    path = str(tmp_path / "log")
    engine = ENGINES[writer](path)
    _fill(engine, writes)
    if compacted:
        size = engine.compact()
        assert 0 < size < sum(8 + len(k) + len(v) for k, v in writes)
        engine.put(b"after", b"compaction")
    engine.close()
    live = _live(writes + ([(b"after", b"compaction")] if compacted else []))
    # A torn tail: half a record header, which every engine drops.
    with open(path, "ab") as f:
        f.write(b"\x05\x00\x00")
    replayed = ENGINES[reader](path)
    _assert_holds(replayed, live)
    replayed.put(b"tail", b"appended after the torn bytes")
    replayed.close()
    again = ENGINES[writer](path)
    _assert_holds(again, {**live, b"tail": b"appended after the torn bytes"})
    again.close()


def test_compaction_keeps_the_live_set_in_both_packages(tmp_path):
    writes = _writes()
    sizes = {}
    for name in ("port", "ref_python"):
        engine = ENGINES[name](str(tmp_path / f"{name}.log"))
        _fill(engine, writes)
        sizes[name] = engine.compact()
        _assert_holds(engine, _live(writes))
        engine.close()
    assert sizes["port"] == sizes["ref_python"] == sum(8 + len(k) + len(v) for k, v in _live(writes).items())


def test_store_actor_reads_writes_and_notifies_as_the_reference(run_async, tmp_path):
    async def drive(cls, path):
        store = cls(path)
        waiter = asyncio.ensure_future(store.notify_read(b"later"))
        await asyncio.sleep(0)
        assert not waiter.done()
        for k, v in _writes(40):
            await store.write(k, v)
        await store.write(b"later", b"value")
        out = [await waiter, await store.read(b"later"), await store.read(b"absent"),
               [await store.read(k) for k, _ in _writes(40)], store.engine_name]
        store.close()
        return out

    ours = run_async(drive(Store, str(tmp_path / "p" / "log")))
    theirs = run_async(drive(r_store.Store, str(tmp_path / "r" / "log")))
    assert ours[:4] == theirs[:4]
    assert ours[4] == "NativeEngine"
    assert run_async(drive(Store, None))[:4] == ours[:4]


def test_an_engine_that_cannot_build_raises(tmp_path, monkeypatch):
    """No quiet fallback to a Python engine: the store raises."""
    monkeypatch.setattr(native_staging, "CXX", "no-such-compiler")
    monkeypatch.setattr(native_staging, "BUILD", tmp_path / "build")
    monkeypatch.setattr(p_store, "_LIB", None)

    async def open_store():
        Store(str(tmp_path / "db" / "log"))

    with pytest.raises(RuntimeError, match="the store engine cannot be built"):
        asyncio.run(open_store())
