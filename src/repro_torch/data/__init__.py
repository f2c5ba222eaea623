"""Synthetic datasets for ``chip_smoke.py`` and the tests."""

from repro_torch.data.timeseries import (  # noqa: F401
    ecg_like,
    mnist_like,
    sinusoid_mixture,
    znormalize,
)
