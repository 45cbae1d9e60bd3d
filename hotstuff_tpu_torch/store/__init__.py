"""The port's copy of `hotstuff_tpu/store/__init__.py`, its imports rewritten to this
package."""

from .store import Store

__all__ = ["Store"]
