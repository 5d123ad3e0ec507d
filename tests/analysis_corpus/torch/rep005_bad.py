"""REP005 seeded violation: a module-level importorskip of a dependency the
module never imports at module level — the whole file skips."""

import pytest

pytest.importorskip("triton")  # expect: REP005


def test_uses_triton_locally():
    import triton

    assert triton.__version__


def test_completely_unrelated():
    assert 1 + 1 == 2
