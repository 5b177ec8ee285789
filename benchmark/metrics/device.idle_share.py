"""device.idle_share: the share of the traced window in which no
operation ran on the device (1 minus the union of device operations over
the window), in %."""


def read(run):
    tr = run.traced
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
