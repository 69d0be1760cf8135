"""upload_ms.caption_device: ``upload_ms.caption`` (which see) in the cells
whose end-to-end metric is ``caption_device_ms``."""

from fpn_mt_image_captioning_torch.utils import profiling


def read(m: dict):
    registry = getattr(profiling, "REGISTRY", None)   # None: a program without spans
    return registry and registry.summary("predict.upload").get("p50_ms")
