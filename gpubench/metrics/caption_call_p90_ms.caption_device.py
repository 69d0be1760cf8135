"""caption_call_p90_ms.caption_device: ``caption_call_p90_ms`` (which see)
in the cells whose end-to-end metric is ``caption_device_ms``."""

import statistics


def read(m: dict):
    if len(m.get("latencies", ())) < 10:
        return None
    return 1e3 * statistics.quantiles(m["latencies"], n=10, method="inclusive")[8]
