"""encode_ms.caption: the wall, in ms, of one ``Pipeline.encode`` of the
cell's batch (the mean of ``span_calls`` encodes timed together by the host
clock, the card synchronised at both ends)."""


def read(m: dict):
    return 1e3 * m["encode_s"] if "encode_s" in m else None
