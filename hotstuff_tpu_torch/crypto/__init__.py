"""Crypto seam of the port: value types, the host signer/verifier and the
`CryptoBackend` that verifies on the card (`torch_backend.TorchBackend`)."""
