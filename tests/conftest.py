import os
import sys

# Tests see ONE device (the dry-run sets its own 512-device flag in a
# separate process); keep any user XLA_FLAGS out of the suite.
os.environ.pop("XLA_FLAGS", None)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (the port's kernel "
        "tests); skipped where there is none")
