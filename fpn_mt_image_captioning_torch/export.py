"""Serving artifacts: the whole serving computation as exported programs that
run without the model code (port of ``fpn_mt_image_captioning_tpu/export.py``).

:func:`export_serving` freezes encode → beam search → stripped sequences
for a fixed image batch into ``torch.export`` programs, and
:func:`load_serving` runs them WITHOUT constructing the model: no
``models/transformer.py``, no module tree, no checkpoint machinery. What the
programs need at serving time is ``torch``, the custom operators of the
decode kernels (``ops/operators.py``, which the loader registers before it
loads a program), the weight file and the tokenizer.

Artifact layout (a directory)::

    serving.pt2, serving_u8.pt2       beam search, float / uint8 images
    sampling.pt2, sampling_u8.pt2     sampling, per-row temperature
    sampling_nucleus.pt2, sampling_nucleus_u8.pt2
                                      sampling, per-row temperature and top_p
    weights.msgpack   the served weights, once, as a Flax msgpack tree
    tokenizer.json    the tokenizer (data/tokenizer.py)
    artifact.json     shapes, tokens, platform and per-program metadata

The sampling programs are present when exported with ``sample=True``. Each
program is ``(weights, images[, noise, temperature[, top_p]]) → (seqs,
lengths)``: the weights are an input (a dict of tensors by state-dict name,
run through ``torch.func.functional_call``), so no program file carries
them. ``weights.msgpack`` holds the weights in the dtypes the pipeline
serves them: float32 for a float32 pipeline (bitwise the JAX package's
variables); for a bfloat16 one the matrices, convolutions and embeddings in
bfloat16 and the LayerNorm and BatchNorm parameters and statistics in
float32, because a bfloat16 pipeline keeps no float32 copy. With the fused
backbone the BatchNorm-folded block weights it runs (folded from float32
before the cast) are stored too, under ``fused_backbone``.

Each program runs a fixed number of decode steps, ``max_seq_len``
(``fixed_steps``): a program cannot read the stop flag on the host. On the
fused route each decode kernel is one custom-operator node, which launches
the hand-written kernel on the card and its plain version on the CPU; the
self-attention node writes the caches in place. A program bakes in the
device of the tensors it makes, so an artifact exported on the CPU is for
the CPU and one exported on the card for the card (``platforms``).

Sampling takes its Gumbel noise as an input, ``(max_seq_len, batch, V)``
float32: :class:`ExportedServing` draws it step by step as
``sample_decode`` does, from a generator on its device seeded with
``fold_chunk_seed(seed, chunk)``, so chunk 0 of a full batch equals
``Pipeline.sample_batch(seed)``.

    python -m fpn_mt_image_captioning_torch.export --out_dir=DIR [--batch=N]
        [--sample] [--verify] [--device=cpu] [any Config --key=value]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

__all__ = ["build_serving_fn", "build_sampling_fn", "fold_chunk_seed", "export_serving",
           "ExportedServing", "load_serving", "main"]

ARTIFACT_META = "artifact.json"
ARTIFACT_FN = "serving.pt2"
ARTIFACT_SAMPLE_FN = "sampling.pt2"                   # temperature only
ARTIFACT_SAMPLE_NUCLEUS_FN = "sampling_nucleus.pt2"   # + per-row top_p
ARTIFACT_U8_FN = "serving_u8.pt2"                     # uint8 twins: normalized on the device
ARTIFACT_SAMPLE_U8_FN = "sampling_u8.pt2"
ARTIFACT_SAMPLE_NUCLEUS_U8_FN = "sampling_nucleus_u8.pt2"
ARTIFACT_WEIGHTS = "weights.msgpack"
ARTIFACT_TOKENIZER = "tokenizer.json"
ARTIFACT_VERSION = 1
BACKBONE = "fused_backbone."   # weight-dict prefix of the fused backbone's folded weights
_BLOCK_KEYS = ("w_exp", "b_exp", "w_dw", "b_dw", "w_proj", "b_proj")
_STEM_KEYS = ("stem_k", "stem_b", "head_k", "head_b")


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------
class _Bound(torch.nn.Module):
    """``run(model, *args)`` as a module that owns ``model``, so that
    ``functional_call`` can run it on other weights."""

    def __init__(self, model, run):
        super().__init__()
        self.model = model
        self.run = run

    def forward(self, *args):
        return self.run(self.model, *args)


def _with_weights(model, run):
    """``fn(weights, images, *rest)``: ``run(model, images, backbone, *rest)``
    with ``weights`` (state-dict names, and ``fused_backbone.*``) in place of
    the model's own."""
    bound = _Bound(model, run)

    def fn(weights, images, *rest):
        own = {"model." + k: v for k, v in weights.items() if not k.startswith(BACKBONE)}
        backbone = {k[len(BACKBONE):]: v for k, v in weights.items() if k.startswith(BACKBONE)}
        return torch.func.functional_call(bound, own, (images, backbone, *rest), strict=True)

    return fn


def _encode(model, images, backbone: dict, blocks):
    """The pipeline's encode: the eager one, or the fused backbone on the
    folded weights ``backbone`` with the blocks' ``(stride, residual)``."""
    if blocks is None:
        return model.encode(images)
    from .ops.fused_backbone import fused_encode

    packed = {k: backbone[k] for k in _STEM_KEYS}
    packed["blocks"] = [({k: backbone[f"blocks.{i}.{k}"] for k in _BLOCK_KEYS
                          if f"blocks.{i}.{k}" in backbone},
                         {"stride": stride, "residual": residual})
                        for i, (stride, residual) in enumerate(blocks)]
    return fused_encode(model, packed, images)


def build_serving_fn(model, *, beam_n: int, max_len: int, start_token: int, end_token: int,
                     fused: bool, pack_dtype: torch.dtype, blocks=None):
    """``(weights, images) → (seqs, lengths)``: the pipeline's encode, then
    fast-mode beam search over exactly ``max_len`` steps (fused: on the
    decode kernels, the decoder weights packed inside the program). The
    function that is exported, and that ``--verify`` runs eagerly beside the
    loaded artifact. ``blocks``: the fused backbone's ``(stride, residual)``
    per block, or None for the eager encode."""
    from .decode.beam_search import beam_search
    from .ops.fused_decoder import pack_decoder_weights

    def run(m, images, backbone):
        enc = _encode(m, images, backbone, blocks)
        seqs, lengths, _scores = beam_search(
            m, enc, beam_n=beam_n, max_len=max_len, start_token=start_token,
            end_token=end_token, fused=fused,
            packed=pack_decoder_weights(m, pack_dtype) if fused else None, fixed_steps=True)
        return seqs, lengths

    return _with_weights(model, run)


def build_sampling_fn(model, *, max_len: int, start_token: int, end_token: int, nucleus: bool,
                      blocks=None):
    """``(weights, images, noise, temperature[, top_p]) → (seqs, lengths)``:
    ``Pipeline.sample_batch``'s computation over exactly ``max_len`` steps,
    on the Gumbel ``noise`` (max_len, B, V) given, with per-row (B,)
    ``temperature`` and, when ``nucleus``, ``top_p``."""
    from .decode.beam_search import sample_decode

    def run(m, images, backbone, noise, temperature, top_p=None):
        enc = _encode(m, images, backbone, blocks)
        return sample_decode(m, enc, None, max_len=max_len, start_token=start_token,
                             end_token=end_token, temperature=temperature, top_p=top_p,
                             noise=noise, fixed_steps=True)

    return _with_weights(model, run)


class _Program(torch.nn.Module):
    """What ``torch.export`` traces: ``fn`` as a module that registers nothing,
    so the exported program lifts no weight."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _kernel_nodes(ep) -> dict[str, int]:
    """Nodes of each custom operator (``fpn_mt::*``) in an exported graph."""
    counts: dict[str, int] = {}
    for node in ep.graph.nodes:
        name = getattr(node.target, "name", lambda: "")() if node.op == "call_function" else ""
        if name.startswith("fpn_mt::"):
            counts[name] = counts.get(name, 0) + 1
    return counts


def _export_program(fn, args, path: str) -> dict:
    """Export ``fn`` on ``args``, save it to ``path``; its statistics."""
    t0 = time.perf_counter()
    # under an outer no_grad: a grad-mode switch inside the traced function
    # would export a node that torch.export.load refuses
    with torch.no_grad():
        ep = torch.export.export(_Program(fn), args, strict=False)
    export_s = time.perf_counter() - t0
    ep.example_inputs = None   # the example weights: saved, they would copy the weights
    torch.export.save(ep, path)
    const_bytes = sum(t.numel() * t.element_size() for t in ep.constants.values()
                      if isinstance(t, torch.Tensor))
    return {"export_s": export_s, "graph_nodes": len(ep.graph.nodes),
            "kernel_nodes": _kernel_nodes(ep), "constant_bytes": const_bytes,
            "state_bytes": sum(t.numel() * t.element_size() for t in ep.state_dict.values()),
            "bytes": os.path.getsize(path)}


def _served_weights(pipeline) -> dict[str, torch.Tensor]:
    """The program's weight input: the served model's state dict and the
    fused backbone's folded weights, by sorted name (the order the loader
    rebuilds)."""
    weights = dict(pipeline.transformer.state_dict())
    if pipeline.backbone_packed is not None:
        bb = pipeline.backbone_packed
        weights.update({BACKBONE + k: bb[k] for k in _STEM_KEYS})
        for i, (blk, _meta) in enumerate(bb["blocks"]):
            weights.update({f"{BACKBONE}blocks.{i}.{k}": v for k, v in blk.items()})
    return dict(sorted(weights.items()))


def _weight_tree(pipeline) -> dict:
    """The Flax-layout tree of ``weights.msgpack``: the served weights in
    their dtypes, and the fused backbone's folded weights."""
    from .weights import to_flax

    tree = to_flax(pipeline.transformer, keep_dtype=True)
    if pipeline.backbone_packed is not None:
        bb = pipeline.backbone_packed
        cpu = lambda t: t.detach().cpu() if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
        tree["fused_backbone"] = {
            **{k: cpu(bb[k]) for k in _STEM_KEYS},
            "blocks": {str(i): {k: cpu(v) for k, v in blk.items()}
                       for i, (blk, _meta) in enumerate(bb["blocks"])}}
    return tree


def fold_chunk_seed(seed: int, chunk: int) -> int:
    """Per-chunk seed for host-side chunked sampling (the JAX package's
    function, the same integers). Chunk 0 keeps ``seed``, so a single-chunk
    call equals the live pipeline's; later chunks run (seed, chunk) through a
    splitmix32-style avalanche, so reuse between consecutive per-batch seeds
    (the server's batcher) and any chunk index is a ~2⁻³² random event, not
    a structured certainty. Wrapped into the int32 range."""
    if chunk == 0:
        v = int(seed) & 0xFFFFFFFF
        return v - 2**32 if v >= 2**31 else v
    x = (int(seed) & 0xFFFFFFFF) ^ ((0x9E3779B9 * chunk) & 0xFFFFFFFF)
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & 0xFFFFFFFF
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x - 2**32 if x >= 2**31 else x


def export_serving(pipeline, out_dir: str, batch: int | None = None,
                   beam_n: int | None = None, sample: bool = False) -> dict:
    """Export ``pipeline``'s serving computation at a fixed ``batch``
    (default ``decode_batch``) to ``out_dir``; returns the metadata that
    ``artifact.json`` holds. One device by design: data-parallel serving
    deploys one artifact per card behind the batcher."""
    cfg = pipeline.config
    if cfg.mesh.enabled:
        raise ValueError("export_serving: export from a mesh-free pipeline "
                         "(--mesh.enabled=false); DP serving = one artifact per card")
    batch = batch or max(cfg.decode_batch, 1)
    beam_n = beam_n or cfg.beam_search_n
    from .ops.fused_decoder import FUSED_ACTIVATIONS

    fused = cfg.use_pallas and not cfg.beam_parity_mode and cfg.activation in FUSED_ACTIVATIONS
    # the live pipeline chunks above this many decode rows; a program's batch
    # is fixed, so an artifact that exceeds it is refused here
    if fused and cfg.max_decode_rows and batch * beam_n > cfg.max_decode_rows:
        raise ValueError(
            f"export_serving: batch*beam = {batch}*{beam_n} = {batch * beam_n} decode rows "
            f"exceeds the fused kernels' per-launch ceiling (Config.max_decode_rows="
            f"{cfg.max_decode_rows}); export a smaller batch — ExportedServing chunks "
            "larger request batches host-side")
    pipeline._sync()
    model, dev = pipeline.transformer, pipeline.device
    blocks = None
    if pipeline.backbone_packed is not None:
        blocks = [(m["stride"], m["residual"]) for _, m in pipeline.backbone_packed["blocks"]]
    weights = _served_weights(pipeline)
    size = cfg.image_input_size
    images = {ARTIFACT_FN: torch.zeros((batch, size, size, 3), device=dev),
              ARTIFACT_U8_FN: torch.zeros((batch, size, size, 3), dtype=torch.uint8, device=dev)}
    serve = build_serving_fn(model, beam_n=beam_n, max_len=pipeline.max_seq_len,
                             start_token=pipeline.start_token, end_token=pipeline.end_token,
                             fused=fused, pack_dtype=pipeline.dtype, blocks=blocks)
    os.makedirs(out_dir, exist_ok=True)
    programs = {fname: _export_program(serve, (weights, img), os.path.join(out_dir, fname))
                for fname, img in images.items()}
    if sample:
        noise = torch.zeros((pipeline.max_seq_len, batch, pipeline.target_vocab_size),
                            device=dev)
        # separate tensors: export would make inputs given as one tensor one input
        rows = lambda: torch.ones((batch,), device=dev)
        for fname, nucleus, img_fname in (
                (ARTIFACT_SAMPLE_FN, False, ARTIFACT_FN),
                (ARTIFACT_SAMPLE_NUCLEUS_FN, True, ARTIFACT_FN),
                (ARTIFACT_SAMPLE_U8_FN, False, ARTIFACT_U8_FN),
                (ARTIFACT_SAMPLE_NUCLEUS_U8_FN, True, ARTIFACT_U8_FN)):
            fn = build_sampling_fn(model, max_len=pipeline.max_seq_len,
                                   start_token=pipeline.start_token,
                                   end_token=pipeline.end_token, nucleus=nucleus, blocks=blocks)
            args = (weights, images[img_fname], noise, rows()) + ((rows(),) if nucleus else ())
            programs[fname] = _export_program(fn, args, os.path.join(out_dir, fname))
    from .weights import write_flax_msgpack

    write_flax_msgpack(os.path.join(out_dir, ARTIFACT_WEIGHTS), _weight_tree(pipeline))
    with open(os.path.join(out_dir, ARTIFACT_TOKENIZER), "w") as f:
        f.write(pipeline.tokenizer.to_json())
    meta = {
        "artifact_version": ARTIFACT_VERSION,
        "torch_version": torch.__version__,
        "platforms": [dev.type],
        "fused_decoder": fused,
        "fused_backbone": blocks is not None,
        "batch": batch,
        "beam_n": beam_n,
        "image_size": size,
        "max_seq_len": pipeline.max_seq_len,
        "start_token": pipeline.start_token,
        "end_token": pipeline.end_token,
        "target_vocab_size": pipeline.target_vocab_size,
        "compute_dtype": cfg.compute_dtype,
        "sampling": sample,
        "accepts_uint8": True,
        "programs": programs,
    }
    with open(os.path.join(out_dir, ARTIFACT_META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------
def _pad_chunk(arr: np.ndarray, rows: int, fill: float = 0.0) -> np.ndarray:
    """``fill``-pad ``arr``'s leading axis up to ``rows`` (per chunk, so only
    the tail chunk allocates)."""
    short = rows - arr.shape[0]
    if short <= 0:
        return arr
    return np.concatenate([arr, np.full((short, *arr.shape[1:]), fill, arr.dtype)])


def _load_weights(path: str, device: torch.device) -> dict[str, torch.Tensor]:
    """``weights.msgpack`` as the programs' weight input, on ``device``."""
    from .weights import _flatten, from_flax, read_flax_msgpack

    tree = read_flax_msgpack(path)
    weights = from_flax(tree, keep_dtype=True)
    for path_, leaf in _flatten(tree.get("fused_backbone", {})):
        weights[BACKBONE + ".".join(path_)] = (
            leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf)))
    return {k: v.to(device) for k, v in sorted(weights.items())}


class ExportedServing:
    """A loaded serving artifact with the serving surface of ``Pipeline``
    (``predict_batch``, ``sample_batch``, ``to_caption``, ``close``), so the
    CLI and the server run on it unchanged, without the model code. The
    weights go to the device at once; each program loads on its first use
    (``load_seconds``)."""

    def __init__(self, path: str, device: str | torch.device | None = None):
        # the programs' custom operators, registered before a program loads
        from .data.tokenizer import Tokenizer
        from .ops import operators  # noqa: F401

        with open(os.path.join(path, ARTIFACT_META)) as f:
            self.meta = json.load(f)
        if self.meta["artifact_version"] > ARTIFACT_VERSION:
            raise ValueError(f"artifact version {self.meta['artifact_version']} is newer than "
                             f"this loader ({ARTIFACT_VERSION})")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device found; an artifact exported on the CPU "
                                   "loads with device='cpu'")
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = torch.device(device)
        platform = self.meta["platforms"][0]
        if self.device.type != platform:
            raise ValueError(f"the artifact at {path} was exported for {platform}, and its "
                             f"programs make their tensors there; it cannot run on "
                             f"{self.device}: export it again on that device")
        self.batch = int(self.meta["batch"])
        self.image_size = int(self.meta["image_size"])
        self.target_vocab_size = int(self.meta["target_vocab_size"])
        self.max_seq_len = int(self.meta["max_seq_len"])
        self.accepts_uint8 = bool(self.meta.get("accepts_uint8", False))
        self.supports_sampling = bool(self.meta.get("sampling", False))
        self.fused_backbone = bool(self.meta.get("fused_backbone", False))
        self.path = path
        self.load_seconds: dict[str, float] = {}   # each program's, once it has loaded
        self._programs: dict[str, torch.nn.Module] = {}
        with open(os.path.join(path, ARTIFACT_TOKENIZER)) as f:
            self.tokenizer = Tokenizer.from_json(f.read())
        self._weights = _load_weights(os.path.join(path, ARTIFACT_WEIGHTS), self.device)

    def program(self, fname: str) -> torch.nn.Module:
        """The program in file ``fname``, loaded on its first use (a loaded
        program costs seconds, and a beam server never runs a sampling
        one)."""
        if fname not in self._programs:
            t0 = time.perf_counter()
            self._programs[fname] = torch.export.load(os.path.join(self.path, fname)).module()
            self.load_seconds[fname] = time.perf_counter() - t0
        return self._programs[fname]

    def apply_to_config(self, cfg):
        """``cfg`` with the artifact's frozen image size, beam and batch (the
        CLI and the server on ``--artifact``)."""
        return dataclasses.replace(cfg, image_input_size=self.image_size,
                                   beam_search_n=int(self.meta["beam_n"]),
                                   decode_batch=self.batch)

    def _coerce_images(self, images):
        """``(images, uint8?)``: uint8 rides the uint8 programs where the
        artifact has them; anything else is float32. An artifact without
        them gets uint8 normalized on the host (a bare cast would feed 0..255
        to a program that expects [-1, 1])."""
        arr = np.asarray(images)
        u8 = arr.dtype == np.uint8
        if u8 and not self.accepts_uint8:
            arr, u8 = arr.astype(np.float32) / 127.5 - 1.0, False
        else:
            arr = np.asarray(arr, np.uint8 if u8 else np.float32)
        if arr.shape[0] == 0:
            raise ValueError("empty batch (need at least 1 image)")
        if arr.shape[1:] != (self.image_size, self.image_size, 3):
            raise ValueError(f"expected (B, {self.image_size}, {self.image_size}, 3) images, "
                             f"got {arr.shape}")
        return arr, u8

    def _run(self, call, images: np.ndarray, extra=lambda chunk, sl: ()):
        """``call`` on each chunk of ``images`` padded onto the fixed batch;
        the results concatenated and cut to the real rows."""
        n_real = images.shape[0]
        seqs, lengths = [], []
        with torch.no_grad():
            for chunk, i in enumerate(range(0, n_real, self.batch)):
                sl = slice(i, i + self.batch)
                x = torch.as_tensor(_pad_chunk(images[sl], self.batch), device=self.device)
                s, n = call(self._weights, x, *extra(chunk, sl))
                seqs.append(s.cpu().numpy())
                lengths.append(n.cpu().numpy())
        return np.concatenate(seqs)[:n_real], np.concatenate(lengths)[:n_real]

    def predict_batch(self, images, beam_n: int | None = None):
        """(B, S, S, 3) uint8 or [-1, 1] float → (seqs (B, L) int32 np,
        lengths (B,) np), for any B ≥ 1: chunked and padded onto the fixed
        batch on the host."""
        if beam_n is not None and beam_n != self.meta["beam_n"]:
            raise ValueError(f"artifact was exported at beam_n={self.meta['beam_n']}; "
                             f"re-export for beam_n={beam_n}")
        images, u8 = self._coerce_images(images)
        return self._run(self.program(ARTIFACT_U8_FN if u8 else ARTIFACT_FN), images)

    def sample_batch(self, images, *, seed: int = 0, temperature=1.0, top_k: int = 0,
                     top_p=None):
        """Sampled captions with ``Pipeline.sample_batch``'s semantics
        (scalar or per-row ``temperature``/``top_p``; ``top_p=None`` takes the
        program without the nucleus sort), chunked as ``predict_batch``; chunk
        ``c`` draws its noise from a generator seeded with
        ``fold_chunk_seed(seed, c)``."""
        from .decode.noise import gumbel

        if not self.supports_sampling:
            raise ValueError("artifact was exported without sampling programs; re-export "
                             "with export --sample (or export_serving(sample=True))")
        if top_k:
            raise ValueError("top_k is a trace-time constant the artifact was exported "
                             "without; re-export to change it")
        images, u8 = self._coerce_images(images)
        n_real = images.shape[0]
        temperature = np.broadcast_to(np.asarray(temperature, np.float32), (n_real,)).copy()
        if top_p is not None:
            top_p = np.broadcast_to(np.asarray(top_p, np.float32), (n_real,)).copy()
        call = self.program({(False, False): ARTIFACT_SAMPLE_FN,
                             (True, False): ARTIFACT_SAMPLE_NUCLEUS_FN,
                             (False, True): ARTIFACT_SAMPLE_U8_FN,
                             (True, True): ARTIFACT_SAMPLE_NUCLEUS_U8_FN}[top_p is not None, u8])
        shape = (self.batch, self.target_vocab_size)

        def extra(chunk, sl):
            gen = torch.Generator(device=self.device).manual_seed(fold_chunk_seed(seed, chunk))
            noise = torch.stack([gumbel(gen, shape, self.device)
                                 for _ in range(self.max_seq_len)])
            rows = [_pad_chunk(temperature[sl], self.batch, 1.0)]
            if top_p is not None:
                rows.append(_pad_chunk(top_p[sl], self.batch, 1.0))
            return (noise, *(torch.as_tensor(r, device=self.device) for r in rows))

        return self._run(call, images, extra)

    def to_caption(self, seq_row, length) -> str:
        tokens = [int(t) for t in seq_row[:length]]
        return self.tokenizer.sequences_to_texts([tokens])[0]

    def caption(self, images) -> list[str]:
        seqs, lengths = self.predict_batch(images)
        return [self.to_caption(s, n) for s, n in zip(seqs, lengths)]

    def close(self) -> None:   # the Pipeline surface (nothing to release)
        pass


def load_serving(path: str, device: str | torch.device | None = None) -> ExportedServing:
    """Load a directory written by :func:`export_serving`: on the CUDA card
    (``device=None``; raises without one) or on ``device``, which must be
    the device the artifact was exported for."""
    return ExportedServing(path, device)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
def _verify(pipeline, served: ExportedServing, meta: dict, sample: bool) -> None:
    """Each loaded program against the same function run eagerly on the same
    inputs (bitwise), as the root ``export.py --verify`` holds the artifact
    to a direct jit of the exported function."""
    blocks = None
    if pipeline.backbone_packed is not None:
        blocks = [(m["stride"], m["residual"]) for _, m in pipeline.backbone_packed["blocks"]]
    weights, dev = _served_weights(pipeline), pipeline.device
    common = dict(max_len=meta["max_seq_len"], start_token=meta["start_token"],
                  end_token=meta["end_token"], blocks=blocks)
    serve = build_serving_fn(pipeline.transformer, beam_n=meta["beam_n"],
                             fused=meta["fused_decoder"], pack_dtype=pipeline.dtype, **common)
    rng = np.random.default_rng(0)
    shape = (meta["batch"], meta["image_size"], meta["image_size"], 3)
    batches = {"float": rng.uniform(-1, 1, shape).astype(np.float32),
               "uint8": rng.integers(0, 256, shape, dtype=np.uint8)}

    def check(label, want, got):
        ok = all(np.array_equal(w.cpu().numpy(), g) for w, g in zip(want, got))
        print(f"verify: {label} artifact bitwise == the exported function run eagerly: {ok}")
        if not ok:
            raise SystemExit(f"{label} verification FAILED")

    with torch.no_grad():
        for label, imgs in batches.items():
            check(f"beam {label}", serve(weights, torch.as_tensor(imgs, device=dev)),
                  served.predict_batch(imgs))
        if not sample:
            return
        from .decode.noise import gumbel

        temps = np.linspace(0.5, 1.2, meta["batch"]).astype(np.float32)
        tps = np.full(meta["batch"], 0.9, np.float32)
        gen = torch.Generator(device=dev).manual_seed(7)
        noise = torch.stack([gumbel(gen, (meta["batch"], meta["target_vocab_size"]), dev)
                             for _ in range(meta["max_seq_len"])])
        for nucleus in (False, True):
            fn = build_sampling_fn(pipeline.transformer, nucleus=nucleus, **common)
            for label, imgs in batches.items():
                rows = (torch.as_tensor(temps, device=dev),) + (
                    (torch.as_tensor(tps, device=dev),) if nucleus else ())
                want = fn(weights, torch.as_tensor(imgs, device=dev), noise, *rows)
                got = served.sample_batch(imgs, seed=7, temperature=temps,
                                          top_p=tps if nucleus else None)
                check(f"sampling{' nucleus' if nucleus else ''} {label}", want, got)


def main(argv: list[str]) -> dict:
    """``python -m fpn_mt_image_captioning_torch.export --out_dir=DIR
    [--batch=N] [--sample] [--verify] [--device=cpu] [overrides]``: the
    pipeline of ``Pipeline.from_config`` (the weights of
    ``--transformer_weight_path``) exported to DIR. Returns the metadata."""
    out_dir, batch, verify, sample, device = None, None, False, False, None
    passthrough = []
    for arg in argv:
        key, _, val = arg.partition("=")
        if key == "--out_dir":
            out_dir = val
        elif key == "--batch":
            batch = int(val)
        elif arg == "--verify":
            verify = True
        elif arg == "--sample":
            sample = True
        elif key == "--device":
            device = val
        else:
            passthrough.append(arg)
    if not out_dir:
        raise SystemExit("usage: python -m fpn_mt_image_captioning_torch.export --out_dir=DIR "
                         "[--batch=N] [--sample] [--verify] [--device=cpu] [config overrides]")
    from .config import Config
    from .train.pipeline import Pipeline

    pipeline = Pipeline.from_config(Config.from_flags(passthrough), device=device)
    try:
        t0 = time.perf_counter()
        meta = export_serving(pipeline, out_dir, batch=batch, sample=sample)
        print(f"exported {meta['platforms']} batch={meta['batch']} beam={meta['beam_n']} "
              f"fused={meta['fused_decoder']} sampling={meta['sampling']} to {out_dir} in "
              f"{time.perf_counter() - t0:.1f}s")
        if verify:
            _verify(pipeline, load_serving(out_dir, pipeline.device), meta, sample)
    finally:
        pipeline.close()
    return meta


if __name__ == "__main__":
    main(sys.argv[1:])
