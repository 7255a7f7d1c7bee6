"""Store: host seconds from the benchmark's arrays to the plan's tables on
the device (``Graph`` tables, the CSR build, ``device_tables``)."""


def read(ctx):
    return ctx.store_build_s
