"""decode_step_roofline.caption_device: ``decode_step_roofline.caption``
(which see) in the cells whose end-to-end metric is ``caption_device_ms``."""

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
