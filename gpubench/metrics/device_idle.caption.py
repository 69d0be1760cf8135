"""device_idle.caption: the share of a ``predict_batch`` call's wall in
which no operation ran on the card, in %: one minus the device's busy time
a call under the profiler over the mean wall of ``span_calls`` calls run
without it (the profiler slows the host, not the card)."""


def read(m: dict):
    if "predict_busy_s" not in m:
        return None
    return 100.0 * (1.0 - m["predict_busy_s"] / m["trace_calls"] / m["span_call_s"])
