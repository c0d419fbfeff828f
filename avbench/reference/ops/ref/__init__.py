"""Numpy scalar reference implementations (bit-exact oracles for TPU kernels)."""
