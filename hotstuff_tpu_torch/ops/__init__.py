"""Batched ed25519 verification ops: GF(2^255 - 19) on integer limbs, the
device hash, curve arithmetic, the Straus ladder, the verifier and its
dispatch pipeline and device timeline; and BLS12-381 G1 committee-key
aggregation (`bls`).

Each CUDA kernel has a wrapper beside its plain PyTorch version: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel (or
raises). Kernels are built from `csrc/` on first use (`_build`)."""
