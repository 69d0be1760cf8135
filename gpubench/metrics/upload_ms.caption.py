"""upload_ms.caption: the wall, in ms, of copying a call's images to the
card: the median of the program's latest 4096 ``predict.upload`` spans
outside the profiler (in a traced run, the window's calls and the encodes
measured after it). None where the program records no such span."""

from fpn_mt_image_captioning_torch.utils import profiling


def read(m: dict):
    registry = getattr(profiling, "REGISTRY", None)   # None: a program without spans
    return registry and registry.summary("predict.upload").get("p50_ms")
