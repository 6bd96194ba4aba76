"""device.idle_share (%): the share of the traced window in which no
kernel, copy or set ran on the card."""


def read(run):
    if not run.device_events or run.window_s <= 0:
        return None
    busy = sum(e - s for s, e in run.busy_intervals()) / 1e9
    return 100.0 * (1.0 - busy / run.window_s)
