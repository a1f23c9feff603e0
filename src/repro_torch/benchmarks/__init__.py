"""Benchmarks of the PyTorch/CUDA port, the counterparts of the JAX
package's ``benchmarks/``."""
