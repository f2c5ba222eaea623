"""Hand-written Hopper kernels for the port, one package per kernel.

Each ``<name>/`` package keeps the JAX package's split: the kernel itself
(CUDA C++ in ``csrc/``, built by ``_build``), a dispatcher ``ops.py`` and
the plain PyTorch version ``ref.py``. A dispatcher follows the tensor's
device: a CPU tensor goes to the plain version, a CUDA tensor launches the
kernel or raises. Each dispatcher counts its kernel launches in its
module's ``LAUNCHES``: a plain integer, or in ``pairwise_reduce``, which
holds three kernels (K3-K5), one integer per kernel name.
"""
