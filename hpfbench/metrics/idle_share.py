"""idle_share (%): the share of the traced window in which no operation
ran on the device."""


def read(ctx: dict):
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
