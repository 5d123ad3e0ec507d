"""REP005 clean twins: the skip is bound to a module-level name, or
narrowed into the test that needs the dependency."""

import pytest

torch = pytest.importorskip("torch")


def test_needs_torch():
    assert torch.zeros(2).sum() == 0


def test_narrowed_skip_inside_test():
    triton = pytest.importorskip("triton")
    assert triton.__version__
