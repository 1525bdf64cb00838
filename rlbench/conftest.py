"""Tests of the benchmark's own code. The `card` marker names the tests
that need a CUDA card; they decide in a fixture, not at import, and skip
without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs a benchmark cell on a CUDA card (skips "
                   "without one)")
