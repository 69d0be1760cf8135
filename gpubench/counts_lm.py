"""The arithmetic of a captioner whose decoder is a language model
(``configs/kimi_vl_a3b_resnet50.json``): the operations and bytes of one
decode step of the beam search, counted for the whole step, and the model
FLOPs of the prefill and of a call, from shapes and the published config.

A step is counted whole, not kernel by kernel, so that a change that fuses
or splits its kernels reads against the same count. Its operations are every
product the absorbed step needs (``models/kimi_vl.py``): per layer the query
and latent projections, the absorption of ``q_nope`` into the latent space,
the scores and the weighted sum over the prefix and the ancestry, the
output's way back through ``W_UV`` and ``W_o``; the router, the 6 chosen
experts and the shared ones of each row (the dense layer's MLP in layer 0);
``lm_head``. Its bytes are each input read once and each output written once:
each weight once (every routed expert that received a row: all of them
when the rows' choices outnumber the experts), the embedding rows of the
step's tokens, each item's prefix latents and the distinct latent rows the
beams' ancestry reaches, the step's ancestry indices, scores and tokens in,
the new latent rows and each item's candidates out. The logits and other
intermediates are not counted.

Step 0 runs no layer: its logits are the prefill's (counted there); it
reads them for the top-k."""

from __future__ import annotations

from .counts import least_seconds


def _widths(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "h": cfg["num_attention_heads"], "r": cfg["kv_lora_rank"],
            "nope": cfg["qk_nope_head_dim"], "pe": cfg["qk_rope_head_dim"],
            "v": cfg["v_head_dim"], "e": cfg["n_routed_experts"],
            "k": cfg["num_experts_per_tok"], "w": cfg["moe_intermediate_size"],
            "shared": cfg["moe_intermediate_size"] * cfg["n_shared_experts"],
            "dense": cfg["intermediate_size"], "layers": cfg["num_hidden_layers"],
            "dense_layers": cfg["first_k_dense_replace"], "vocab": cfg["vocab_size"]}


def _token_flops(x: dict) -> tuple[float, float]:
    """Products a token costs in a layer's FFN: a MoE layer's (the router,
    its chosen and its shared experts) and a dense one's."""
    moe = 2 * x["d"] * x["e"] + 2 * 3 * x["d"] * (x["k"] * x["w"] + x["shared"])
    dense = 2 * 3 * x["d"] * x["dense"]
    return moe, dense


def layer_weights(cfg: dict, experts_used: int | None = None) -> float:
    """Parameters of the language model's layers read by a step, the final
    norm and ``lm_head``: all but the embedding table, and of the routed
    experts only ``experts_used`` (default all)."""
    x = _widths(cfg)
    used = x["e"] if experts_used is None else experts_used
    attn = (x["d"] * x["h"] * (x["nope"] + x["pe"]) + x["d"] * (x["r"] + x["pe"]) + x["r"]
            + x["r"] * x["h"] * (x["nope"] + x["v"]) + x["h"] * x["v"] * x["d"] + 2 * x["d"])
    moe = x["e"] * x["d"] + x["e"] + used * 3 * x["d"] * x["w"] + 3 * x["d"] * x["shared"]
    dense = 3 * x["d"] * x["dense"]
    n_moe = x["layers"] - x["dense_layers"]
    return (x["layers"] * attn + n_moe * moe + x["dense_layers"] * dense + x["d"]
            + x["d"] * x["vocab"])


def decode_step(cfg: dict, items: int, beam: int, prefix: int, pos: int,
                distinct_rows: float, esz: int = 2) -> tuple[float, float]:
    """``(flops, bytes)`` of step ``pos`` (≥ 1) for ``items × beam`` rows;
    ``prefix`` is the visual prefix and ``<start>`` (17), ``distinct_rows``
    the mean number of (position, beam) rows an item's beams read over
    positions ``0..pos`` (``reference.decode.distinct_ancestors``: the
    beams' own rows at ``pos`` are this step's output, and position 0, every
    beam's ``<start>``, is one row of the prefix, so the ancestry reads
    ``distinct_rows − beam − 1``)."""
    x = _widths(cfg)
    rows = items * beam
    keys = prefix + pos                          # the prefix and slots 1 .. pos
    lat = x["r"] + x["pe"]
    attn = 2 * rows * (x["d"] * x["h"] * (x["nope"] + x["pe"]) + x["d"] * lat
                       + x["h"] * x["nope"] * x["r"] + x["h"] * x["v"] * x["r"]
                       + x["h"] * x["v"] * x["d"])
    scores = 2 * rows * x["h"] * (lat + x["r"]) * keys
    moe, dense = _token_flops(x)
    n_moe = x["layers"] - x["dense_layers"]
    flops = (x["layers"] * (attn + scores) + rows * (n_moe * moe + x["dense_layers"] * dense)
             + 2 * rows * x["d"] * x["vocab"])
    experts_used = min(x["e"], rows * x["k"])
    ancestry = max(distinct_rows - beam - 1, 0.0)
    nbytes = (layer_weights(cfg, experts_used) * esz
              + rows * x["d"] * esz                                  # the tokens' embeddings
              + x["layers"] * items * (prefix + ancestry) * lat * esz
              + rows * (pos + 1) * 8 + rows * (4 + 1 + 8)            # ancestry, scores, tokens in
              + x["layers"] * rows * lat * esz                       # the new latent rows out
              + rows * beam * (4 + 8 + 8))                           # candidates out
    return float(flops), float(nbytes)


def first_step_bytes(cfg: dict, items: int, esz: int = 2) -> float:
    """Step 0: the prefill's logits read for the top-k."""
    return float(items * cfg["vocab_size"] * esz)


def step_least_seconds(cfg: dict, items: int, prefix: int, distinct: list[float]) -> list[float]:
    """The least time of each of the ``len(distinct)`` steps of a call."""
    beam = cfg["beam_search_n"]
    out = [least_seconds(0.0, first_step_bytes(cfg, items))]
    out += [least_seconds(*decode_step(cfg, items, beam, prefix, t, distinct[t]))
            for t in range(1, len(distinct))]
    return out


def prefill_flops(cfg: dict, items: int, lenc: int) -> float:
    """The projector and the language model over ``lenc`` visual tokens and
    ``<start>`` of ``items`` images (causal attention, ``lm_head`` at the
    last position)."""
    x = _widths(cfg)
    n = lenc + 1
    tokens = items * n
    d_in = cfg["d_model"]
    projector = 2 * items * lenc * (d_in * d_in + d_in * x["d"])
    attn = 2 * tokens * (x["d"] * x["h"] * (x["nope"] + x["pe"]) + x["d"] * (x["r"] + x["pe"])
                         + x["r"] * x["h"] * (x["nope"] + x["v"]) + x["h"] * x["v"] * x["d"])
    causal = n * (n + 1) // 2
    scores = 2 * items * x["h"] * (x["nope"] + x["pe"] + x["v"]) * causal
    moe, dense = _token_flops(x)
    n_moe = x["layers"] - x["dense_layers"]
    return float(projector + x["layers"] * (attn + scores)
                 + tokens * (n_moe * moe + x["dense_layers"] * dense)
                 + 2 * items * x["d"] * x["vocab"])


def call_flops(cfg: dict, items: int, lenc: int, steps: int) -> float:
    """The prefill and the ``steps`` steps of a call (step 0 has no layer)."""
    beam = cfg["beam_search_n"]
    return prefill_flops(cfg, items, lenc) + sum(
        decode_step(cfg, items, beam, lenc + 1, t, 0.0)[0] for t in range(1, steps))
