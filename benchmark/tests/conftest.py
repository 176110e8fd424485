"""Settings of the benchmark's own tests (``python -m pytest benchmark/tests``
from the root of the repo; the card's: ``-m gpu``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
