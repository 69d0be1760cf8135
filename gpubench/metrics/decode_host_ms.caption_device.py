"""decode_host_ms.caption_device: ``decode_host_ms.caption`` (which see) in
the cells whose end-to-end metric is ``caption_device_ms``."""

from fpn_mt_image_captioning_torch.utils import profiling


def read(m: dict):
    registry = getattr(profiling, "REGISTRY", None)   # None: a program without spans
    s = registry.summary("beam.issue") if registry is not None else {}
    return s.get("host_p50_ms", s.get("p50_ms"))   # the latter: a span without waits
