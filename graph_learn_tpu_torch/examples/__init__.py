"""Runnable examples and measurement harnesses of the port; each runnable
module has ``main`` (most also ``run``); ``common`` and ``data`` hold the
pieces the supervised examples share."""
