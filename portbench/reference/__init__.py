"""The benchmark's plain reference: threefry keys and bits, the SGNS step
with both negative draws, and the ALiR merge, in plain PyTorch and NumPy.

Frozen copies, each file naming the code it was copied from. Nothing here
imports the system under test, JAX or the JAX package."""
