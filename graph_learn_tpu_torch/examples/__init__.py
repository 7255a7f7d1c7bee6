"""Runnable examples and measurement harnesses of the port; each module is
importable and has ``run`` and ``main``."""
