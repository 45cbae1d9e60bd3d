"""The port's copy of `hotstuff_tpu/network/__init__.py`, its imports rewritten to this
package."""

from .net import NetMessage, NetReceiver, NetSender

__all__ = ["NetMessage", "NetReceiver", "NetSender"]
