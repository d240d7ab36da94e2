"""The port's stencil geometry and constants against the JAX package's.

The port keeps its own copy of ops/stencil.py and ops/constants.py (it may
not import the JAX package); these pin the copies to the originals
bit for bit, for eps in 1..40.
"""

import math

import numpy as np
import pytest

from nonlocalheatequation_torch.ops import constants as TC
from nonlocalheatequation_torch.ops import stencil as TS
from nonlocalheatequation_tpu.ops import constants as JC
from nonlocalheatequation_tpu.ops import stencil as JS


@pytest.mark.parametrize("eps", range(1, 41))
def test_masks_heights_and_constants_match(eps):
    assert np.array_equal(TS.column_half_heights(eps), JS.column_half_heights(eps))
    assert np.array_equal(TS.horizon_mask_1d(eps), JS.horizon_mask_1d(eps))
    assert np.array_equal(TS.horizon_mask_2d(eps), JS.horizon_mask_2d(eps))
    for k, dh in ((1.0, 0.02), (0.2, 0.02), (0.02, 0.01), (0.5, 1.0 / 4096)):
        assert TC.c_1d(k, eps, dh) == JC.c_1d(k, eps, dh)
        assert TC.c_2d(k, eps, dh) == JC.c_2d(k, eps, dh)
        for dim, c in ((1, TC.c_1d(k, eps, dh)), (2, TC.c_2d(k, eps, dh))):
            wsum = float(TS.horizon_mask_1d(eps).sum() if dim == 1
                         else TS.horizon_mask_2d(eps).sum())
            assert TC.stable_dt(c, dh, dim, wsum) == JC.stable_dt(c, dh, dim, wsum)


def test_weighted_influence_and_precision_tiers_match():
    mask = TS.horizon_mask_2d(6)
    J = lambda r: math.exp(-r)  # noqa: E731
    assert np.array_equal(TS.influence_weights(mask, J, 0.1),
                          JS.influence_weights(JS.horizon_mask_2d(6), J, 0.1))
    assert TC.PRECISION_TIERS == JC.PRECISION_TIERS
    assert TC.BF16_L2_BUDGET == JC.BF16_L2_BUDGET
    # the reference's 1D long cast: k=0.02, eps=40, dx=0.019 truncates to 0
    assert TC.c_1d(0.02, 40, 0.019) == 0.0 and TC.stable_dt(0.0, 0.019, 1, 81.0) == math.inf
    with pytest.raises(ValueError, match="unknown precision tier"):
        TC.validate_precision("f16")
