"""The benchmark's tests: `cuda` marks a test that needs CUDA cards; it
decides inside the test and skips without them."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs CUDA cards; skips without them")
