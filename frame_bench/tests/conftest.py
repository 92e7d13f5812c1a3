"""Fixtures of the frame benchmark's tests: a scratch copy of the
benchmark with a 64-plate, 64x64 configuration and one cell of each
mode, which the harness runs on the CPU."""

import pytest

from fb_helpers import make_tiny_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where torch sees none")


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
