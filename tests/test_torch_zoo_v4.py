"""The YOLOv4 zoo models (Darknet / CSP and MobileNet stacks) not held
elsewhere, port against JAX at full width: the check and the bounds of
``test_torch_zoo.py``, in a file of their own so that xdist spreads the
zoo over two workers."""

import pytest

from tests.test_torch_zoo import ZOO_V4, hold_against_jax


@pytest.mark.parametrize("name", ZOO_V4)
def test_zoo_v4_apply_folded_matches_jax(name):
    hold_against_jax(name)
