"""pytest settings of the benchmark's own tests (`python -m pytest
cachebench/`)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")
