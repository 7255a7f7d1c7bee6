"""pytest settings of the benchmark's own tests (``gnnbench/tests``).

``chip``: a test that needs a CUDA card.  Each such test decides inside
itself whether a card is present and skips without one; on the card run
them with ``python3 -m pytest gnnbench/tests -m chip``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")
