"""K1: tiled matrix product (replaces ``repro/kernels/matmul``)."""
