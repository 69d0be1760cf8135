"""caption_call_p90_ms: the 90th percentile, in ms, of the latency of the
window's ``predict_batch`` calls (closed loop: from when a call was due, the
previous one's return, to its captions as host arrays). p90 is the highest
percentile with ten calls or more beyond it at 100-200 calls a window. Its
spread between runs is too wide for an end-to-end bound (``PERF.md``)."""

import statistics


def read(m: dict):
    if len(m.get("latencies", ())) < 10:
        return None
    return 1e3 * statistics.quantiles(m["latencies"], n=10, method="inclusive")[8]
