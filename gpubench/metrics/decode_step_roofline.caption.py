"""decode_step_roofline.caption: the least time of a decode step (the
larger of its operations over the bf16 peak and its bytes over the memory
rate, counted for the whole step by ``gpubench/counts.py``, the
self-attention rows as far as the beams' ancestry reaches) over the
device's time a step, in %. The device's time of the steps is the busy time
of the profiled ``predict_batch`` calls less that of as many encodes."""

from gpubench import counts


def read(m: dict):
    if "distinct" not in m or "predict_busy_s" not in m:
        return None
    decode_busy = (m["predict_busy_s"] - m["encode_busy_s"]) / m["trace_calls"]
    if decode_busy <= 0:
        return None
    least = counts.decode_least_seconds(m["cfg"], m["vocab"], m["items"], m["lenc"],
                                        m["distinct"][: m["steps"]])
    return 100.0 * sum(least) / decode_busy
