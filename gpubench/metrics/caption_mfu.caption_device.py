"""caption_mfu.caption_device: ``caption_mfu`` (which see) in the cells
whose end-to-end metric is ``caption_device_ms``."""

from gpubench import counts


def read(m: dict):
    if "call_flops" not in m:
        return None
    return 100.0 * m["call_flops"] * m["calls"] / (m["window_s"] * counts.PEAK_BF16_FLOPS)
