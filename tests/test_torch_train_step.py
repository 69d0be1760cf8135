"""The port's training step against the JAX package's, on the CPU, at a small
size (256², mobilenet224_0.35, d_model 32, 2+2 layers, dff 64, 4 heads): the
loss, the schedule, per-variable clipping and Keras AMSGrad, BatchNorm in
training mode, the loss and every gradient of the training forward, a 3-step
``Pipeline.train_step`` trajectory, dropout, ``remat_encoder`` and bfloat16
compute. Inputs come from numpy seeds; weights cross with ``from_flax``.
Each tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

from fixtures import make_synthetic_dataset
from fpn_mt_image_captioning_tpu.config import Config as JxConfig
from fpn_mt_image_captioning_tpu.data.tokenizer import Tokenizer as JxTokenizer
from fpn_mt_image_captioning_tpu.data.tokenizer import store_tokenizer_to_path
from fpn_mt_image_captioning_tpu.models.positional import create_masks as jx_masks
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_tpu.train import losses as jx_losses
from fpn_mt_image_captioning_tpu.train import schedule as jx_schedule
from fpn_mt_image_captioning_tpu.train.pipeline import Pipeline as JxPipeline
from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import BatchNorm32
from fpn_mt_image_captioning_torch.models.layers import Dropout
from fpn_mt_image_captioning_torch.models.positional import create_masks
from fpn_mt_image_captioning_torch.models.transformer import Transformer
from fpn_mt_image_captioning_torch.train import losses, schedule
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from fpn_mt_image_captioning_torch.weights import _flax_tree, from_flax, to_flax
from test_torch_slice import CFG, MAX_LEN, SIZE, fit

FIELDS = dict(image_input_size=SIZE, backbone=CFG.backbone, d_model=CFG.d_model,
              num_layers=CFG.num_layers, num_heads=CFG.num_heads, dff=CFG.dff,
              compute_dtype="float32", dropout_rate=0.0, warm_up_steps=10, batch_size=3)
B = 3


def flat(tree) -> dict:
    return traverse_util.flatten_dict(jax.device_get(tree), sep="/")


@pytest.fixture(scope="module")
def world():
    """The JAX model's own init (float32, dropout 0), a batch of 3 seeded
    images and captions (one row partly padded, one all padding), and a
    port model holding the same weights."""
    jtok = fit(JxTokenizer)
    vocab = len(jtok.index_word)
    jx = JxTransformer(num_layers=CFG.num_layers, d_model=CFG.d_model, num_heads=CFG.num_heads,
                       dff=CFG.dff, input_vocab_size=CFG.input_vocab_size,
                       target_vocab_size=vocab, max_seq_len=MAX_LEN, backbone_name=CFG.backbone,
                       rate=0.0)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    captions = rng.integers(1, vocab, (B, MAX_LEN)).astype(np.int32)
    captions[1, 5:] = 0
    captions[2] = 0
    key = jax.random.PRNGKey(5)
    tar = jnp.asarray(captions[:1, :-1])
    variables = jax.device_get(jax.jit(lambda i, t: jx.init(
        {"params": key, "dropout": key}, i, t, True, jx_masks(t)))(
        jnp.zeros((1, SIZE, SIZE, 3)), tar))
    variables = jax.tree.map(np.asarray, variables)
    return dict(jx=jx, jtok=jtok, vocab=vocab, images=images, captions=captions,
                variables=variables)


def port_model(world, dtype=torch.float32, **kw) -> Transformer:
    m = Transformer(CFG.num_layers, CFG.d_model, CFG.num_heads, CFG.dff, CFG.input_vocab_size,
                    world["vocab"], max_seq_len=MAX_LEN, backbone_name=CFG.backbone,
                    compute_dtype=dtype, **kw)
    m.load_state_dict(from_flax(world["variables"]))
    return m


def jax_loss_and_grads(world, dtype):
    jm = world["jx"].clone(dtype=jnp.dtype(dtype))
    caps = jnp.asarray(world["captions"])
    tar_inp, tar_real = caps[:, :-1], caps[:, 1:]
    stats = world["variables"]["batch_stats"]

    def loss_fn(params):
        (logits, _), mut = jm.apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(world["images"]), tar_inp, True,
                                    jx_masks(tar_inp), mutable=["batch_stats"])
        return jx_losses.masked_sparse_ce(tar_real, logits), mut["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        world["variables"]["params"])
    return float(loss), flat(new_stats), flat(grads)


def port_loss_and_grads(model, world, drop=None):
    caps = torch.as_tensor(world["captions"]).long()
    tar_inp, tar_real = caps[:, :-1], caps[:, 1:]
    logits, _ = model.forward_train(torch.as_tensor(world["images"]), tar_inp,
                                    create_masks(tar_inp), drop)
    loss = losses.masked_sparse_ce(tar_real, logits)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, dict(zip(names, grads))


# ---------------------------------------------------------------------------
def test_masked_sparse_ce_matches_jax():
    """Padding zeroed, the denominator the rows with any token × L; an
    all-padding batch divides by one row (rtol 1e-6)."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 6, 11)) * 3).astype(np.float32)
    real = rng.integers(1, 11, (4, 6)).astype(np.int32)
    real[1, 3:] = 0
    real[3] = 0
    for r in (real, np.zeros_like(real)):
        want = float(jx_losses.masked_sparse_ce(jnp.asarray(r), jnp.asarray(logits)))
        got = losses.masked_sparse_ce(torch.as_tensor(r), torch.as_tensor(logits))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # the all-zero rows do not dilute: the loss of the 3 rows with tokens
    # equals that of the batch without the padding row
    three = losses.masked_sparse_ce(torch.as_tensor(real[:3]), torch.as_tensor(logits[:3]))
    full = losses.masked_sparse_ce(torch.as_tensor(real), torch.as_tensor(logits))
    np.testing.assert_allclose(float(full), float(three), rtol=1e-6)


@pytest.mark.parametrize("uses_dff", [True, False])
def test_custom_schedule_matches_jax(uses_dff):
    """lr at steps 0, 1, w and 3w (rtol 1e-6), with and without the dff
    quirk; lr(0) = 0, so the first update is zero."""
    cfg = Config(schedule_uses_dff=uses_dff, warm_up_steps=40)
    d = cfg.dff if cfg.schedule_uses_dff else cfg.d_model
    got, want = schedule.custom_schedule(d, 40), jx_schedule.custom_schedule(d, 40)
    for step in (0, 1, 40, 120):
        np.testing.assert_allclose(float(got(step)), float(want(step)), rtol=1e-6)
    assert float(got(0)) == 0.0
    rough, jx_rough = schedule.custom_schedule_rough(), jx_schedule.custom_schedule_rough()
    for step in (0, 3, 12, 20, 40):
        np.testing.assert_allclose(float(rough(step)), float(jx_rough(step)), rtol=1e-6)


def test_clip_and_keras_adam_match_jax():
    """Per-variable clipping then Keras AMSGrad over 5 steps on the same
    numpy gradients, one tensor above the clip norm and one below, against
    the JAX package's ``make_optimizer`` (params and m, v, vhat: rtol 1e-6,
    atol 1e-9)."""
    rng = np.random.default_rng(1)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    lr = jx_schedule.custom_schedule(8, 2)
    opt = jx_schedule.make_optimizer(lr)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = opt.init(jparams)
    params = [torch.tensor(p0["a"]), torch.tensor(p0["b"])]
    state = schedule.keras_adam_init(params)
    for step in range(5):
        g = {"a": (rng.standard_normal((3, 4)) * 3).astype(np.float32),    # norm > 1
             "b": (rng.standard_normal(5) * 0.01).astype(np.float32)}      # norm < 1
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = [torch.tensor(g["a"]), torch.tensor(g["b"])]
        schedule.clip_by_per_variable_norm_(grads, 1.0)
        assert abs(float(grads[0].norm()) - 1.0) < 1e-6
        torch.testing.assert_close(grads[1], torch.tensor(g["b"]), rtol=0, atol=0)
        state = schedule.keras_adam_(params, grads, state, schedule.custom_schedule(8, 2))
        adam = jstate[1]
        assert state.count == int(adam.count) == step + 1
        for i, k in enumerate("ab"):
            for got, want in ((params[i], jparams[k]), (state.m[i], adam.m[k]),
                              (state.v[i], adam.v[k]), (state.vhat[i], adam.vhat[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    assert not np.allclose(params[0].numpy(), p0["a"])


@pytest.mark.parametrize("momentum", [0.999, 0.9])
def test_batchnorm_training_matches_flax(momentum):
    """``BatchNorm32(train=True)`` against ``flax.linen.BatchNorm(
    use_running_average=False)``: the output (atol 1e-5) and the running
    statistics after two updates (rtol 1e-6, atol 1e-7)."""
    rng = np.random.default_rng(2)
    c = 6
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=1e-3)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    port = BatchNorm32(c, momentum=momentum)
    with torch.no_grad():
        for t, a in ((port.weight, scale), (port.bias, bias), (port.running_mean, mean0),
                     (port.running_var, var0)):
            t.copy_(torch.from_numpy(a))
    for _ in range(2):
        x = (rng.standard_normal((3, 5, 7, c)) * 2 + 1.5).astype(np.float32)
        want, mut = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), train=True)
        np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want),
                                   atol=1e-5)
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   np.asarray(mut["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   np.asarray(mut["batch_stats"]["var"]), rtol=1e-6, atol=1e-7)


def test_loss_and_every_gradient_match_jax(world):
    """The training forward's loss (rtol 1e-5) and the gradient of every
    parameter against ``jax.value_and_grad`` of the JAX ``Transformer``
    (float32, dropout 0), and the BatchNorm statistics it updates (rtol 1e-5,
    atol 1e-6).

    Gradient tolerance, per tensor: ``‖Δ‖ ≤ 5e-2·(‖g_jax‖ + 1e-3·max‖g‖)``,
    and the median over tensors ≤ 5e-3. Training-mode BatchNorm over 17
    blocks makes float32 gradients ill-conditioned: each package's float32
    gradients stray from a float64 evaluation of the same function by a
    median 3e-3-5e-3 and up to ~1e-2 (early backbone layers), so the two
    packages can agree no closer than that."""
    want_loss, want_stats, want = jax_loss_and_grads(world, "float32")
    model = port_model(world)
    loss, grads = port_loss_and_grads(model, world)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    got = flat(_flax_tree(model, grads.items())["params"])
    assert set(got) == set(want)
    gmax = max(np.linalg.norm(np.asarray(g)) for g in want.values())
    errs = []
    for k, w in want.items():
        w = np.asarray(w)
        err = np.linalg.norm(got[k] - w) / (np.linalg.norm(w) + 1e-3 * gmax)
        assert err <= 5e-2, (k, err)
        errs.append(err)
    assert np.median(errs) <= 5e-3, np.median(errs)
    stats = flat(to_flax(model)["batch_stats"])
    for k, w in want_stats.items():
        np.testing.assert_allclose(stats[k], np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=k)


def test_bf16_compute_loss_matches_jax_and_params_stay_float32(world, tmp_path):
    """bfloat16 compute with float32 parameters: the loss within 1e-2
    (relative) of the JAX package's bf16 loss on the same weights, every
    gradient float32; then a bf16 ``Pipeline.train_step`` leaves every
    parameter and statistic float32."""
    want_loss, _, _ = jax_loss_and_grads(world, "bfloat16")
    model = port_model(world, torch.bfloat16)
    loss, grads = port_loss_and_grads(model, world)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-2)
    assert all(g.dtype == torch.float32 for g in grads.values())
    pipe = Pipeline(fit_port(world), MAX_LEN, Config(**{**FIELDS, "compute_dtype": "bfloat16"}),
                    world["variables"], device="cpu", checkpoint_path=str(tmp_path / "ckpt"))
    assert np.isfinite(pipe.train_step(world["images"], world["captions"]))
    assert all(t.dtype == torch.float32 for t in pipe.state.model.state_dict().values())
    assert pipe.transformer.decoder.embedding.weight.dtype == torch.bfloat16


def fit_port(world):
    from fpn_mt_image_captioning_torch.data.tokenizer import Tokenizer

    return fit(Tokenizer)


def test_three_step_trajectory_matches_jax_pipeline(world, tmp_path):
    """Three ``Pipeline.train_step``s of both packages from the same weights
    (float32, dropout 0, warm_up_steps 10: lr(0) = 0, so steps 0 and 1 run
    on the starting weights and the update before step 2 moves them).

    Losses: steps 0 and 1 rtol 1e-4. Step 2 rtol 1e-3: its weights come
    from an AMSGrad update that is about ``alpha·sign(g)`` on every weight
    (the moments of two equal gradients), and the float32 gradients of the
    two packages differ by up to ~1e-2 in the early backbone (training-mode
    BatchNorm amplifies rounding; each package is as far from a float64
    evaluation, and with BatchNorm and LayerNorm in float64 the two agree to
    a median 5e-5), so the signs of the small gradient entries differ and
    the loss after the update differs by ~4e-4. BatchNorm statistics: the
    step-2 batch moments come from the updated weights, so the largest
    deviation of a running statistic is held within 5e-2 of the largest
    distance a statistic moved (measured 2.4e-2); the step counters equal.

    Parameters, for the same reason: each within 2.5·Σalpha_t of JAX's (two
    opposite updates of at most ~1.2·alpha a step), and the median deviation
    over all weights within 2e-2·Σalpha_t, while the median weight moves by
    ~0.9·Σalpha_t."""
    jtok = world["jtok"]
    store_tokenizer_to_path(jtok, str(tmp_path / "tok.json"))
    datadir = make_synthetic_dataset(str(tmp_path / "data"), n_train=1, n_val=1)
    jcfg = JxConfig(**FIELDS, datadir=datadir,
                    transformer_checkpoint_path=str(tmp_path / "jx_ckpt"))
    jpipe = JxPipeline(str(tmp_path / "tok.json"), jcfg.transformer_checkpoint_path, MAX_LEN,
                       jcfg)
    jpipe.state = jpipe.state._replace(params=world["variables"]["params"],
                                       batch_stats=world["variables"]["batch_stats"])
    pipe = Pipeline(str(tmp_path / "tok.json"), MAX_LEN, Config(**FIELDS), world["variables"],
                    device="cpu", checkpoint_path=str(tmp_path / "ckpt"))
    alphas = []
    for step in range(3):
        alphas.append(schedule.keras_alpha(pipe.learning_rate(step), step))
        want = jpipe.train_step(world["images"], world["captions"])
        got = pipe.train_step(world["images"], world["captions"])
        np.testing.assert_allclose(got, want, rtol=1e-4 if step < 2 else 1e-3)
    assert pipe.train_loss_history[-1] < pipe.train_loss_history[0]
    tree = pipe.state_tree()
    assert int(tree["step"]) == int(jpipe.state.step) == 3
    assert int(tree["opt_state"]["1"]["count"]) == int(jpipe.state.opt_state[1].count) == 3
    got, start = flat(tree["batch_stats"]), flat(world["variables"]["batch_stats"])
    want = {k: np.asarray(w) for k, w in flat(jpipe.state.batch_stats).items()}
    assert got.keys() == want.keys()
    dev = max(np.abs(got[k] - w).max() for k, w in want.items())
    moved = max(np.abs(w - start[k]).max() for k, w in want.items())
    assert dev <= 5e-2 * moved, (dev, moved)
    total = sum(alphas)
    start, got, want = flat(world["variables"]["params"]), flat(tree["params"]), \
        flat(jpipe.state.params)
    dev = np.concatenate([np.abs(got[k] - np.asarray(w)).ravel() for k, w in want.items()])
    moved = np.concatenate([np.abs(np.asarray(w) - start[k]).ravel() for k, w in want.items()])
    assert dev.max() <= 2.5 * total, (dev.max(), total)
    assert np.median(dev) <= 2e-2 * total, (np.median(dev), total)
    assert np.median(moved) >= 0.5 * total, (np.median(moved), total)


def test_dropout_masks():
    """Kept fraction ≈ 1 − rate (0.9 ± 0.003 over 10⁶ values), kept values
    scaled by 1/0.9; the same (seed, step, site) draws the same mask, another
    step, site or seed another; rate 0 is the identity."""
    x = torch.ones(1000, 1000)
    drop = Dropout(0.1, seed=0, step=4, device=torch.device("cpu"))
    y = drop(x, "decoder.layer_0.dropout1")
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 3e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    again = Dropout(0.1, seed=0, step=4, device=torch.device("cpu"))(x, "decoder.layer_0.dropout1")
    assert torch.equal(again, y)
    for other in (Dropout(0.1, 0, 5, torch.device("cpu"))(x, "decoder.layer_0.dropout1"),
                  drop(x, "decoder.layer_0.dropout2"),
                  Dropout(0.1, 1, 4, torch.device("cpu"))(x, "decoder.layer_0.dropout1")):
        assert (other != y).float().mean().item() > 0.1
    assert Dropout(0.0, 0, 0, torch.device("cpu"))(x, "any") is x


def test_remat_encoder_gives_the_same_gradients_at_dropout(world):
    """``remat_encoder`` recomputes each encoder layer in the backward pass;
    the masks are a function of (seed, step, site), so the recompute draws
    the forward's masks: the loss and every gradient equal without and with
    it at rate 0.1 (rtol 1e-6, atol 1e-9), and the masks do act (the loss
    differs from rate 0)."""
    drop = lambda: Dropout(0.1, seed=3, step=2, device=torch.device("cpu"))
    plain_loss, plain = port_loss_and_grads(port_model(world), world, drop())
    remat_loss, remat = port_loss_and_grads(port_model(world, remat_encoder=True), world, drop())
    torch.testing.assert_close(remat_loss, plain_loss, rtol=1e-6, atol=1e-9)
    for k in plain:
        torch.testing.assert_close(remat[k], plain[k], rtol=1e-6, atol=1e-9, msg=k)
    off_loss, _ = port_loss_and_grads(port_model(world), world, None)
    assert abs(off_loss.item() - plain_loss.item()) > 1e-4
