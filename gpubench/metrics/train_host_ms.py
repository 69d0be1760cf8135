"""train_host_ms: the host's own time, in ms, to issue a training step, from
its upload to the issue of its AMSGrad update: the median, over the
program's latest 4096 ``train.issue`` spans outside the profiler, of each
span less its waits for the card (the spans marked as waits inside it: the
positional-encoding uploads and the per-variable clip's scales; see
``fpn_mt_image_captioning_torch/utils/profiling.py``). The loss's read-back
is outside it. None where the program records no such span."""

from fpn_mt_image_captioning_torch.utils import profiling


def read(m: dict):
    registry = getattr(profiling, "REGISTRY", None)   # None: a program without spans
    s = registry.summary("train.issue") if registry is not None else {}
    return s.get("host_p50_ms", s.get("p50_ms"))   # the latter: a span without waits
