"""A world of one rank on NCCL on the CUDA card (phase 18 (d) of
chip_smoke.py, at a small size: 256², mobilenet224_0.35, d 32, 2+2 layers):
through an explicit 1 × 1 mesh three sharded steps equal three
``train_step``s from the same weights (the first loss bitwise; every loss
within rtol 1e-5, every weight within atol 2e-5: the card's convolution
gradients sum in another order run to run, tests/test_torch_cuda_train.py),
and the sharded fused beam search equals ``beam_search`` bitwise. Needs a CUDA
card: every test here skips on a machine without one. On the card (which has
no JAX, so the JAX-side conftest is skipped):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_parallel.py
"""

import socket

import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_torch.config import Config, MeshConfig
from fpn_mt_image_captioning_torch.data.tokenizer import REFERENCE_FILTERS, Tokenizer
from fpn_mt_image_captioning_torch.decode.beam_search import beam_search
from fpn_mt_image_captioning_torch.parallel.mesh import make_mesh
from fpn_mt_image_captioning_torch.parallel.train import (make_sharded_beam_search,
                                                          make_sharded_train_step, shard_state)
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

pytestmark = pytest.mark.cuda
MAX_LEN, BATCH = 8, 4
CFG = Config(image_input_size=256, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
             num_heads=4, dff=64, compute_dtype="float32", dropout_rate=0.1, beam_search_n=3,
             batch_size=BATCH)


@pytest.fixture
def nccl_world_of_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.distributed.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                         rank=0, world_size=1)
    try:
        yield dev, make_mesh(MeshConfig(), "cuda")
    finally:
        torch.distributed.destroy_process_group()


def test_world_of_one_rank_on_nccl(nccl_world_of_one, tmp_path):
    dev, mesh = nccl_world_of_one
    assert torch.distributed.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(20)]
    tok = Tokenizer(num_words=CFG.top_k, oov_token="unk", filters=REFERENCE_FILTERS)
    tok.fit_on_texts(["<start> " + " ".join(rng.choice(words, 5)) + " <end>" for _ in range(30)])
    tok.add_padding_token()
    images = rng.integers(0, 256, (BATCH, 256, 256, 3), dtype=np.uint8)
    caps = rng.integers(1, len(tok.index_word), (BATCH, MAX_LEN)).astype(np.int64)
    caps[1, 5:] = 0
    plain, sharded = (Pipeline(tok, MAX_LEN, CFG, seed=2, device=dev,
                               checkpoint_path=str(tmp_path / k)) for k in ("plain", "sharded"))
    state, placements = shard_state(mesh, sharded.state)
    assert not any(d is not None for d in placements.values())
    step = make_sharded_train_step(mesh, sharded.learning_rate, placements, seed=CFG.seed,
                                   dropout_rate=CFG.dropout_rate)
    want = [plain.train_step(images, caps) for _ in range(3)]
    got = []
    for _ in range(3):
        state, loss = step(state, torch.as_tensor(images, device=dev),
                           torch.as_tensor(caps, device=dev))
        got.append(float(loss))
    assert got[0] == want[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    b = dict(state.model.named_parameters())
    for k, p in plain.state.model.named_parameters():
        torch.testing.assert_close(b[k], p, atol=2e-5, rtol=0, msg=k)
    plain._sync()
    enc = plain.encode(images)
    kw = dict(beam_n=CFG.beam_search_n, max_len=MAX_LEN, start_token=plain.start_token,
              end_token=plain.end_token)
    ws, wl, _ = beam_search(plain.transformer, enc, fused=True, packed=plain.packed, **kw)
    gs, gl, _ = make_sharded_beam_search(mesh, plain.transformer, packed=plain.packed, **kw)(enc)
    assert torch.equal(ws, gs) and torch.equal(wl, gl)
