"""decode_host_ms.caption: the host's own time, in ms, to issue one
beam-search step (the expansion with its decode step's launches, and the
loop's bookkeeping; the stop test's wait for the card is outside it): the
median of the program's latest 4096 ``beam.issue`` spans outside the
profiler (the registry's ring; in a traced run, the window's last calls and
the calls measured after it), each less any wait for the card inside it
(the fused decode step has none). None where the program records no such
span."""

from fpn_mt_image_captioning_torch.utils import profiling


def read(m: dict):
    registry = getattr(profiling, "REGISTRY", None)   # None: a program without spans
    s = registry.summary("beam.issue") if registry is not None else {}
    return s.get("host_p50_ms", s.get("p50_ms"))   # the latter: a span without waits
