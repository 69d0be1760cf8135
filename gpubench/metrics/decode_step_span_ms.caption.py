"""decode_step_span_ms.caption: the wall, in ms, of one beam-search step as
the program times it (the stop test, then the issue of the step's work;
``fpn_mt_image_captioning_torch/utils/profiling.py``): the median of its
latest 4096 ``beam.step`` spans outside the profiler (the registry's ring;
in a traced run, the window's last calls and the calls measured after it).
None where the program records no such span."""

from fpn_mt_image_captioning_torch.utils import profiling


def read(m: dict):
    registry = getattr(profiling, "REGISTRY", None)   # None: a program without spans
    return registry and registry.summary("beam.step").get("p50_ms")
