"""PyTorch + CUDA port of the JAX package ``repro`` (which stays the
reference).  Imports torch, numpy and the standard library only."""
