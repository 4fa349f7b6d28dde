"""layout_s (s): host seconds of the port's `build_device_data` for the cell's
COO, ended by a synchronize (the benchmark's own span around the call)."""


def read(ctx: dict):
    return ctx["layout_s"]
