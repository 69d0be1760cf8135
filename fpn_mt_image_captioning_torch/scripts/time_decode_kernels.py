"""Time the decode step's products and LayerNorm, and the whole step, on the
card through the wrappers a decode runs, for one checkout of the port:

    python fpn_mt_image_captioning_torch/scripts/time_decode_kernels.py [--root=DIR]

``--root`` names the checkout whose ``fpn_mt_image_captioning_torch`` is
imported (default: the one holding this file), so two versions of the port
can be timed on one card in turns (parent, change, change, parent) with the
same code. Everything it calls exists in every version since the decode step
was ported: ``decoder_linear(x, w, b, act, out_f32)``,
``decoder_add_layernorm``, ``pack_decoder_weights``, ``init_fused_cache``,
``fused_decode_step``, ``utils.profiling.cuda_kernel_times``.

Per case it prints the card's time a call (sum of kernel durations in the
CUDA profiler over ``ITERS`` calls) and the host's (CUDA events around
``ITERS`` calls, which on this host-bound loop time the host; median of
``REPS``), as one JSON line with the card's name and power limit. Shapes:
the flagship decode (B·beam = 512 or 64 rows, d 512, dff 2048, 8 heads, 6
layers, vocabulary 2000, bf16, seeded weights)."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ITERS, REPS = 50, 5
D, H, DFF, NL, V, BEAM, LENC, MAX_LEN = 512, 8, 2048, 6, 2000, 8, 16, 60


def main(argv) -> int:
    root = Path(__file__).resolve().parents[2]
    for a in argv:
        if a.startswith("--root="):
            root = Path(a.split("=", 1)[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_decode_kernels: needs a CUDA card")
    from fpn_mt_image_captioning_torch.models.transformer import Transformer
    from fpn_mt_image_captioning_torch.ops import fused_decoder as fd
    from fpn_mt_image_captioning_torch.utils.profiling import cuda_kernel_times
    from fpn_mt_image_captioning_torch.weights import init_weights

    dev, bf16 = torch.device("cuda", 0), torch.bfloat16
    g = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def timed(fn) -> dict:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(REPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                fn()
            end.record()
            torch.cuda.synchronize()
            walls.append(start.elapsed_time(end) * 1e3 / ITERS)
        for _ in range(12):   # a window whose count is not a multiple of ITERS lost launches
            rows, _ = cuda_kernel_times(lambda: [fn() for _ in range(ITERS)])
            launches = sum(c for _, _, c in rows)
            if launches and launches % ITERS == 0:
                return {"device_us": sum(us for _, us, _ in rows) / ITERS,
                        "host_us": statistics.median(walls)}
        raise SystemExit("time_decode_kernels: the CUDA profiler lost launches in 12 windows")

    out = {"root": str(root)}
    for m in (BEAM * 64, BEAM * 8):
        # the step's five distinct linear shapes (cross q and out share out's)
        for name, k, n, act, out_f32 in (
                ("qkv", D, 3 * D, "none", False), ("out", D, D, "none", True),
                ("ffn1", D, DFF, "leaky_relu", False), ("ffn2", DFF, D, "none", True),
                ("vocab", D, V, "none", True)):
            x, w, b = rand(m, k, dtype=bf16), rand(k, n, scale=k ** -0.5, dtype=bf16), rand(n)
            out[f"linear_{name}_M{m}"] = timed(lambda: fd.decoder_linear(x, w, b, act, out_f32))
        y, r = rand(m, D), rand(m, D, dtype=bf16)
        gamma, beta = 1 + rand(D, scale=0.1), rand(D, scale=0.1)
        out[f"add_layernorm_rows{m}"] = timed(
            lambda: fd.decoder_add_layernorm(y, r, gamma, beta, bf16))

    with torch.device("meta"):
        model = Transformer(NL, D, H, DFF, 16, V, max_seq_len=MAX_LEN + 1,
                            backbone_name="mobilenet224_0.35", activation="leaky_relu")
    model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(1))
    packed = fd.pack_decoder_weights(model.to(dev), bf16)
    for b_items in (64, 8):
        bk = b_items * BEAM
        cache = fd.init_fused_cache(packed, rand(b_items, LENC, D, dtype=bf16), BEAM, MAX_LEN)
        src_t = (torch.arange(bk, device=dev) % BEAM).to(torch.int32)[None].repeat(
            cache["k_self"].shape[1], 1)
        x, scores, fin = rand(bk, D, dtype=bf16), rand(bk, 1), torch.zeros(bk, 1, device=dev)
        out[f"step_batch{b_items}_pos8"] = timed(lambda: fd.fused_decode_step(
            packed, cache, x, src_t, 8, scores, fin, num_layers=NL, beam=BEAM, num_heads=H,
            topk=BEAM, activation="leaky_relu"))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
