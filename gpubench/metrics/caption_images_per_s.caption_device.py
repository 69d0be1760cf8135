"""caption_images_per_s.caption_device: the images captioned in the window
over the window's whole time, the quantity of the end-to-end metric
``caption_images_per_s``, read per layer in the cells whose end-to-end
metric is ``caption_device_ms``: there the host's drift from run to run
spreads it wider than any end-to-end bound (``PERF.md`` §2)."""


def read(m: dict):
    if not m.get("window_s"):
        return None
    return m["images"] / m["window_s"]
