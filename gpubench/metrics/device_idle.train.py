"""device_idle.train: the share of a training step's wall in which no
operation ran on the card, in %: one minus the device's busy time a step
under the profiler over the window's mean step (the profiler slows the
host, not the card)."""


def read(m: dict):
    if "train_busy_s" not in m:
        return None
    return 100.0 * (1.0 - m["train_busy_s"] / m["trace_calls"] * m["steps"] / m["window_s"])
