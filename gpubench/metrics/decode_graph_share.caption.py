"""decode_graph_share.caption: the share, in %, of the beam search's decode
steps that replayed a captured CUDA graph: 100 × the program's
``beam.replay`` spans over its ``beam.kernels`` spans (one a decode step on
either route; ``fpn_mt_image_captioning_torch/decode/beam_search.py``),
counted outside the profiler since the process started, warm-up included.
None where no step replayed a graph (a program without the graph route, or
a run on the CPU)."""

from fpn_mt_image_captioning_torch.utils import profiling


def read(m: dict):
    registry = getattr(profiling, "REGISTRY", None)   # None: a program without spans
    if registry is None:
        return None
    replays = registry.summary("beam.replay").get("steps")
    steps = registry.summary("beam.kernels").get("steps")
    return 100.0 * replays / steps if replays and steps else None
