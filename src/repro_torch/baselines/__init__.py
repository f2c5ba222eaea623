"""Baseline dimensionality reduction operators from the paper's comparison
(§2.3): FFT, Haar DWT, PAA and JL random projection.

Host numpy in float64 with the JAX package's ``np.random.default_rng``
streams, as the JAX package computes them: the same data gives the same
expansions, operators and k on every device. Their min-k searches are the
one-step reducers of ``core.reducer``. (The full-SVD baselines,
``repro/baselines/svd_pca.py``, are not ported yet.)"""

from repro_torch.baselines.dwt import haar_expansion  # noqa: F401
from repro_torch.baselines.fft import fft_real_expansion  # noqa: F401
from repro_torch.baselines.jl import jl_operator, jl_transform  # noqa: F401
from repro_torch.baselines.paa import paa_transform  # noqa: F401
