"""decode_step_ms.caption: the wall, in ms, of one beam-search step: the
mean wall of the beam search inside ``span_calls`` calls of
``predict_batch`` (the card synchronised before and after it, no profiler
running), over the steps a call runs."""


def read(m: dict):
    if "search_s" not in m:
        return None
    return 1e3 * m["search_s"] / m["steps"]
