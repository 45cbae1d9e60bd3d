"""The control and the planted faults: wrappers that put a broken answer
in the timed path, under the service, once the window opens (`armed`).

  * `group_verdict`, the control: the backend's verdict taken for the
    whole call, as ed25519 batch verification gives one answer for a
    batch (`CryptoBackend.verify_batch`): every lane of a call answered
    with whether all of its lanes are valid. It breaks the configuration's
    guarantee that each lane's verdict is exact.
  * `stale`: each call answered with the previous call's mask (the state
    left unchanged), cut or padded to the call's length.
  * `half`: only the first half of each call's lanes verified; the rest
    answered with the majority verdict of that half.
  * `flip`: one lane of each call's mask inverted where it is produced.
  * `silent`: one call of the window never answered within the grace
    (it sleeps `silent_s`), which breaks the guarantee that every
    submitted signature is answered.
"""

from __future__ import annotations

import threading
import time


class _Wrapper:
    def __init__(self, inner) -> None:
        self._inner = inner
        self.armed = False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def verify_batch_mask(self, messages, keys, signatures, committee: bool = False):
        mask = self._inner.verify_batch_mask(messages, keys, signatures, committee=committee)
        if not self.armed:
            return mask
        return self.fault(list(mask), messages, keys, signatures, committee)


class GroupVerdict(_Wrapper):
    def fault(self, mask, *_):
        return [all(mask)] * len(mask)


class Stale(_Wrapper):
    def __init__(self, inner) -> None:
        super().__init__(inner)
        self._last: list | None = None
        self._lock = threading.Lock()

    def fault(self, mask, *_):
        with self._lock:
            last, self._last = self._last, mask
        if last is None:
            return mask
        return (last * (len(mask) // max(1, len(last)) + 1))[: len(mask)]


class Half(_Wrapper):
    def verify_batch_mask(self, messages, keys, signatures, committee: bool = False):
        if not self.armed or len(messages) < 2:
            return self._inner.verify_batch_mask(messages, keys, signatures, committee=committee)
        h = len(messages) // 2
        head = list(self._inner.verify_batch_mask(messages[:h], keys[:h], signatures[:h], committee=committee))
        rest = sum(head) * 2 >= len(head)
        return head + [rest] * (len(messages) - h)


class Flip(_Wrapper):
    def fault(self, mask, *_):
        mask[len(mask) // 2] = not mask[len(mask) // 2]
        return mask


class Silent(_Wrapper):
    silent_s = 90.0

    def __init__(self, inner) -> None:
        super().__init__(inner)
        self._done = False
        self._lock = threading.Lock()

    def fault(self, mask, *_):
        with self._lock:
            first, self._done = not self._done, True
        if first:
            time.sleep(self.silent_s)
        return mask


FAULTS = {"group_verdict": GroupVerdict, "stale": Stale, "half": Half, "flip": Flip, "silent": Silent}
