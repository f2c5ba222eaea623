"""repro_torch — DROP (Suri & Bailis, 2017) in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``repro`` module for module: the same public
functions, numpy results, and the same RNG streams, with the Pallas kernels
replaced by hand-written CUDA kernels (``repro_torch.kernels``).

Public API:
    repro_torch.core       -- the DROP optimizer (paper Algorithm 2) and the
                              Reducer protocol (make_reducer, reduce)
    repro_torch.baselines  -- the FFT, Haar DWT, PAA and JL baselines (host numpy)
    repro_torch.analytics  -- the downstream 1-NN retrieval, DBSCAN and KDE
    repro_torch.pipeline   -- the §4.4 workload optimizer (WorkloadOptimizer)
    repro_torch.data       -- synthetic UCR-like and MNIST-like datasets
    repro_torch.interop    -- fitted maps carried to and from ``repro``

Entry points take ``device=`` and default to "cuda"; pass "cpu" for the
plain PyTorch path.
"""

__version__ = "0.1.0"
