"""The port's client ingress plane: signed client transactions through
admission control into the shared batch verification service.

A copy of `hotstuff_tpu/ingress/`:
  * `messages.py`  — signed ClientTransaction + IngressResponse wire format
  * `admission.py` — fee lanes, bounded queues, shed + retry-after
  * `pipeline.py`  — admission → BatchVerificationService → sink
  * `server.py`    — the framed TCP front end (`IngressServer`,
                     `IngressClient`) a node serves with `--ingress`
  * `loadgen.py`   — open-loop arrival curves, signed traffic, latency stats

Not ported: the chaos scenarios' `IngressLoad`.
"""

from .admission import AdmissionController, IngressConfig, LaneSpec
from .loadgen import ArrivalCurve, OpenLoopLoadGen, make_signer
from .messages import (
    ACCEPTED,
    BAD_SIGNATURE,
    MALFORMED,
    REPLAY,
    SHED,
    ClientTransaction,
    IngressResponse,
    decode_ingress_message,
    encode_ingress_message,
)
from .pipeline import IngressPipeline
from .server import IngressClient, IngressServer

__all__ = [
    "ACCEPTED",
    "BAD_SIGNATURE",
    "MALFORMED",
    "REPLAY",
    "SHED",
    "AdmissionController",
    "ArrivalCurve",
    "ClientTransaction",
    "IngressClient",
    "IngressConfig",
    "IngressPipeline",
    "IngressResponse",
    "IngressServer",
    "LaneSpec",
    "OpenLoopLoadGen",
    "decode_ingress_message",
    "encode_ingress_message",
    "make_signer",
]
