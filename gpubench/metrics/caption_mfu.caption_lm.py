"""caption_mfu.caption_lm: the model FLOPs of the window's captioning calls
(the encode, the prefill and every decode step a call needs,
``gpubench/counts.py`` and ``gpubench/counts_lm.py``) over the window's
time and the card's bf16 peak, in %, in the cells whose decoder is a
language model."""

from gpubench import counts


def read(m: dict):
    if "call_flops" not in m:
        return None
    return 100.0 * m["call_flops"] * m["calls"] / (m["window_s"] * counts.PEAK_BF16_FLOPS)
