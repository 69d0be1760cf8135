"""encode_ms.caption_device: ``encode_ms.caption`` (which see) in the cells
whose end-to-end metric is ``caption_device_ms``."""


def read(m: dict):
    return 1e3 * m["encode_s"] if "encode_s" in m else None
