"""The training step on the CUDA card: one step against the CPU's from the
same weights, and two runs of two steps from the same seed. A small float32
model (256², mobilenet224_0.35, d 32, 2+2 layers). Needs a CUDA card: every
test here skips on a machine without one. On the card (which has no JAX, so
the JAX-side conftest is skipped):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_train.py
"""

import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.data.tokenizer import REFERENCE_FILTERS, Tokenizer
from fpn_mt_image_captioning_torch.models.positional import create_masks
from fpn_mt_image_captioning_torch.train.losses import masked_sparse_ce
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from fpn_mt_image_captioning_torch.train.schedule import keras_alpha
from fpn_mt_image_captioning_torch.weights import to_flax

pytestmark = pytest.mark.cuda
MAX_LEN = 8
CFG = Config(image_input_size=256, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
             num_heads=4, dff=64, compute_dtype="float32", warm_up_steps=10, batch_size=3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def setup():
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(20)]
    tok = Tokenizer(num_words=CFG.top_k, oov_token="unk", filters=REFERENCE_FILTERS)
    tok.fit_on_texts(["<start> " + " ".join(rng.choice(words, 5)) + " <end>" for _ in range(30)])
    tok.add_padding_token()
    vocab = len(tok.index_word)
    images = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    caps = rng.integers(1, vocab, (3, MAX_LEN)).astype(np.int32)
    caps[1, 5:] = 0
    variables = to_flax(Pipeline(tok, MAX_LEN, CFG, seed=2, device="cpu").transformer)
    return tok, variables, images, caps


def loss_and_grads(model, images, caps):
    dev = next(model.parameters()).device
    caps = torch.as_tensor(caps, device=dev).long()
    logits, _ = model.forward_train(torch.as_tensor(images, device=dev), caps[:, :-1],
                                    create_masks(caps[:, :-1]))
    loss = masked_sparse_ce(caps[:, 1:], logits)
    names = [n for n, _ in model.named_parameters()]
    return loss.item(), dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


def test_train_step_on_the_card_matches_the_cpu(dev, setup, tmp_path):
    """Dropout 0, the same weights: the loss rtol 1e-4; every gradient per
    tensor within 5e-2·(‖g_cpu‖ + 1e-3·max‖g‖), the median within 1e-2
    (training-mode BatchNorm makes float32 gradients this ill-conditioned;
    ``tests/test_torch_train_step.py`` measures the same against JAX); after
    two ``train_step``s (lr(0) = 0) each weight within 2.5·alpha of the CPU's,
    the median within 2e-2·alpha."""
    tok, variables, images, caps = setup
    cfg = CFG.replace(dropout_rate=0.0)
    cpu, card = (Pipeline(tok, MAX_LEN, cfg, variables, device=d,
                          checkpoint_path=str(tmp_path / str(i)))
                 for i, d in enumerate(("cpu", dev)))
    cpu_loss, cpu_g = loss_and_grads(cpu.state.model, images, caps)
    card_loss, card_g = loss_and_grads(card.state.model, images, caps)
    assert card_loss == pytest.approx(cpu_loss, rel=1e-4)
    gmax = max(float(g.norm()) for g in cpu_g.values())
    errs = [float((card_g[k].cpu() - g).norm()) / (float(g.norm()) + 1e-3 * gmax)
            for k, g in cpu_g.items()]
    assert max(errs) <= 5e-2 and np.median(errs) <= 1e-2
    for p in (cpu, card):
        p.train_step(images, caps)
        p.train_step(images, caps)
    alpha = keras_alpha(cpu.learning_rate(1), 1)
    dev_all = torch.cat([(card.state.model.state_dict()[k].cpu() - t).abs().flatten()
                         for k, t in cpu.state.model.state_dict().items()])
    assert float(dev_all.max()) <= 2.5 * alpha
    assert float(dev_all.median()) <= 2e-2 * alpha
    assert all(t.is_cuda and t.dtype == torch.float32
               for t in card.state.model.state_dict().values())


def test_same_seed_gives_the_same_steps_on_the_card(dev, setup, tmp_path):
    """Dropout 0.1: two pipelines from the same weights and seed draw the
    same masks, so the first step's loss is bitwise equal (lr(0) = 0 leaves
    the weights as they were); the second step's losses agree within rtol
    1e-3 (the gradients' reductions on the card may sum in another order,
    and the sign-like AMSGrad update carries that into the weights). Another
    seed draws other masks."""
    tok, variables, images, caps = setup
    runs = []
    for i, seed in enumerate((0, 0, 1)):
        pipe = Pipeline(tok, MAX_LEN, CFG.replace(seed=seed), variables, device=dev,
                        checkpoint_path=str(tmp_path / str(i)))
        runs.append([pipe.train_step(images, caps) for _ in range(2)])
    (a0, a1), (b0, b1), (c0, _) = runs
    assert a0 == b0
    assert b1 == pytest.approx(a1, rel=1e-3)
    assert c0 != a0
