"""caption_mfu: the model FLOPs of the window's captioning calls (the encode
and every decode step a call needs, ``gpubench/counts.py``) over the
window's time and the card's bf16 peak, in %."""

from gpubench import counts


def read(m: dict):
    if "call_flops" not in m:
        return None
    return 100.0 * m["call_flops"] * m["calls"] / (m["window_s"] * counts.PEAK_BF16_FLOPS)
