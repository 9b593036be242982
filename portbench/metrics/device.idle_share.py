"""device.idle_share: 1 - (the union of every device activity's
interval in the window) / the window, as a share."""


def read(r):
    return 1.0 - r.busy_s / r.window_s if r.window_s > 0 else None
