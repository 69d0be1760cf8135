"""decode_step_ms.caption_device: ``decode_step_ms.caption`` (which see) in
the cells whose end-to-end metric is ``caption_device_ms``."""


def read(m: dict):
    if "search_s" not in m:
        return None
    return 1e3 * m["search_s"] / m["steps"]
