"""Consensus wire forms the port's bench encodes: `QC` and `AggQC`
(`messages.py`). The consensus core itself is not ported."""
