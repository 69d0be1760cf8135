"""device_idle.caption_device: ``device_idle.caption`` (which see) in the
cells whose end-to-end metric is ``caption_device_ms``."""


def read(m: dict):
    if "predict_busy_s" not in m:
        return None
    return 100.0 * (1.0 - m["predict_busy_s"] / m["trace_calls"] / m["span_call_s"])
