"""train_mfu: the model FLOPs of the window's training steps (forward and
backward, ``gpubench/counts.py``) over the window's time and the card's
bf16 peak, in %."""

from gpubench import counts


def read(m: dict):
    if "step_flops" not in m:
        return None
    return 100.0 * m["step_flops"] * m["steps"] / (m["window_s"] * counts.PEAK_BF16_FLOPS)
