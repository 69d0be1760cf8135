"""Faults planted in a captioner whose decoder is a language model
(``models/kimi_vl.py``), each of which has to turn ``correct`` false:
``control_lm.py`` reads them on the card at the cell's own size, and the CPU
rehearsal (``tests/test_gpubench_caption_lm.py``) plants each at a tiny
size. The signature is ``faults.py``'s: the captioner's ``Pipeline`` class
(unused here) and a ``setattr`` that undoes itself."""

from __future__ import annotations

import torch


def route_without_bias(_pipeline_cls, setattr):
    """The router chooses its experts by the scores ``s`` alone, without the
    correction bias ``b`` (``noaux_tc`` chooses by ``s + b``)."""
    from fpn_mt_image_captioning_torch.models import kimi_vl

    setattr(kimi_vl.Router, "select", lambda self, s: torch.topk(s, self.top_k, dim=-1).indices)


def shared_experts_left_out(_pipeline_cls, setattr):
    """A MoE layer returns its routed experts' part alone."""
    from fpn_mt_image_captioning_torch.models import kimi_vl

    def routed_only(self, x, counter="moe.rows"):
        return self.routed(x.reshape(-1, x.shape[-1]), counter).view(x.shape)

    setattr(kimi_vl.MoE, "forward", routed_only)


CAPTION_LM = (route_without_bias, shared_experts_left_out)
