"""moe_rows_per_expert.caption_lm: the rows a routed expert computed in a
mixture-of-experts layer of a decode step, on the mean over the experts and
the layer-steps: the program's ``moe.rows`` counter (a table of layers ×
experts that each decode step's MoE layers add their rows into, on the
card) over its tallies and the experts. 2048 rows × 6 choices over 64
experts make 192 when no row is dropped; a change that drops rows reads
lower. None where the program keeps no such counter."""

from fpn_mt_image_captioning_torch.utils import profiling


def read(m: dict):
    registry = getattr(profiling, "REGISTRY", None)   # None: a program without spans
    s = registry.summary("moe.rows") if registry is not None else {}
    return s.get("mean")
