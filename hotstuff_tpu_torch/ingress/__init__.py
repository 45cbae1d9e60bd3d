"""The port's client ingress plane: signed client transactions through
admission control into the shared batch verification service.

A trimmed copy of `hotstuff_tpu/ingress/`, the modules the bench's
`--ingress` leg reaches:
  * `messages.py`  — signed ClientTransaction + IngressResponse wire format
  * `admission.py` — fee lanes, bounded queues, shed + retry-after
  * `pipeline.py`  — admission → BatchVerificationService → sink
  * `loadgen.py`   — open-loop arrival curves, signed traffic, latency stats

Not ported: `server.py` (`IngressServer` / `IngressClient`, the framed TCP
front end over the reference's network layer) and the chaos scenarios'
`IngressLoad`.
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

__all__ = [
    "ACCEPTED",
    "BAD_SIGNATURE",
    "MALFORMED",
    "REPLAY",
    "SHED",
    "AdmissionController",
    "ArrivalCurve",
    "ClientTransaction",
    "IngressConfig",
    "IngressPipeline",
    "IngressResponse",
    "LaneSpec",
    "OpenLoopLoadGen",
    "decode_ingress_message",
    "encode_ingress_message",
    "make_signer",
]
