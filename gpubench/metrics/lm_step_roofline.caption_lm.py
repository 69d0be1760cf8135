"""lm_step_roofline.caption_lm: the least time of a call's decode steps (of
each, the larger of its operations over the bf16 peak and its bytes over
the memory rate, counted for the whole step by ``gpubench/counts_lm.py``,
the latent rows as far as the beams' ancestry reaches) over the card's
time of those steps, in %. The card's time of the steps is the busy time of
the profiled ``predict_batch`` calls less that of as many encodes and
prefills."""

from gpubench import counts_lm


def read(m: dict):
    if "distinct" not in m or "prefill_busy_s" not in m:
        return None
    busy = (m["predict_busy_s"] - m["encode_busy_s"] - m["prefill_busy_s"]) / m["trace_calls"]
    if busy <= 0:
        return None
    least = counts_lm.step_least_seconds(m["cfg"], m["items"], m["lenc"] + 1,
                                         m["distinct"][: m["steps"]])
    return 100.0 * sum(least) / busy
