"""lm_prefill_ms.caption_lm: the card's time, in ms, of a call's prefill
(the projector and the language model over each image's 16 visual tokens
and ``<start>``, once an image): the median of the program's ``lm.prefill``
spans outside the profiler (warm-up, the window and the calls measured
after it), each timed by CUDA events on the card
(``fpn_mt_image_captioning_torch/utils/profiling.py``); their host time
where the program has no card time. None where the program records no such
span."""

from fpn_mt_image_captioning_torch.utils import profiling


def read(m: dict):
    registry = getattr(profiling, "REGISTRY", None)   # None: a program without spans
    s = registry.summary("lm.prefill") if registry is not None else {}
    return s.get("device_p50_ms", s.get("p50_ms"))
