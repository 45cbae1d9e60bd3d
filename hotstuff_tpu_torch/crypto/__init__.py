"""Crypto seam of the port: value types, the host signer/verifier and the
`CryptoBackend` that verifies on the card (`torch_backend.TorchBackend`);
the exact BLS12-381 code of aggregate certificates (`aggsig`)."""
