"""Utilities of the port: building the CUDA kernels (:mod:`.build`)."""
