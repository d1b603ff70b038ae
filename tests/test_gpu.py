"""On-card tests (marker `gpu`); they skip without a GPU.  Run them on the
card with:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_oracle_parity_on_gpu(gpu):
    """KDE and RGBF at 96x128 against the NumPy oracles, on the card's
    numerics (the smoke run's phase 3)."""
    chip_smoke.oracle_parity()


def test_tables_exact_on_gpu(gpu):
    """One-hot gathers bit-exact and segment sums within f32 rounding of a
    float64 sum at 640x480 x 300 clusters (the smoke run's phase 5)."""
    chip_smoke.phase_tables()
