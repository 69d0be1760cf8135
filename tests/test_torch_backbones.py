"""The port's ResNet, VGG and DenseNet backbones against the JAX package's, on
the CPU, on the same numpy-seeded weights carried across by
``weights.from_flax``: the registry and its eleven names; the parameter
tree; C3/C4/C5 of all eight new names at 64² in inference and, one depth per
family, in training mode with the updated running statistics; empty extents
below 2. Each family's whole model against JAX's is in
tests/test_torch_backbone_models.py. Each tolerance is stated where it is
used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from fpn_mt_image_captioning_tpu.models.backbones import backbone as jx_backbone
from fpn_mt_image_captioning_torch.models.backbones import backbone
from fpn_mt_image_captioning_torch.models.layers import BatchNorm32
from fpn_mt_image_captioning_torch.weights import from_flax, to_flax

ATOL, RTOL = 2e-4, 1e-3   # the JAX package's bar for backbone taps
S = 64                    # backbone tests: C5 at 2²
TAPS = {"mobilenet224_1.0": (32, 96, 1280), "mobilenet224_0.75": (24, 72, 1280),
        "mobilenet224_0.35": (16, 32, 1280),
        "resnet50": (512, 1024, 2048), "resnet101": (512, 1024, 2048),
        "resnet152": (512, 1024, 2048), "vgg16": (256, 512, 512), "vgg19": (256, 512, 512),
        "densenet121": (512, 1024, 1024), "densenet169": (512, 1280, 1664),
        "densenet201": (512, 1792, 1920)}
NEW = [n for n in TAPS if not n.startswith("mobilenet")]
FAMILIES = ["resnet50", "vgg16", "densenet121"]   # the smallest depth of each


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (restored after): at these
    small shapes more threads only add synchronisation, and the suite runs
    in several worker processes at once, whose threads would oversubscribe
    the cores (alone: 1.6 cores of CPU time for the same wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree) -> dict:
    return traverse_util.flatten_dict(jax.device_get(tree), sep="/")


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def seeded(tree, seed: int) -> dict:
    """Numpy-seeded leaves shaped as ``tree``'s (a Flax-layout tree), from a
    unit-variance uniform N (cheaper to draw than a normal for 60M weights):
    kernels and projection stacks N·√(2/fan_in), BatchNorm and LayerNorm
    scales 1 + 0.1·N, running variances U(0.5, 1.5), every other leaf
    (biases, means, embeddings) 0.1·N — no leaf at an init value of 0 or 1
    that would hide a mapping bug."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        shape, name = np.shape(a), path[-1]
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        noise = rng.random(shape, dtype=np.float32) * np.float32(2 * 3**0.5) - np.float32(3**0.5)
        if name == "scale":
            return 1.0 + 0.1 * noise
        if name in ("kernel", "kv_proj", "wq", "wo"):
            fan_in = int(np.prod(shape[:-1])) if name == "kernel" else shape[-2]
            return noise * np.float32(np.sqrt(2.0 / fan_in))
        return 0.1 * noise

    return {c: traverse_util.unflatten_dict(
        {k: leaf(k, v) for k, v in traverse_util.flatten_dict(tree[c]).items()})
        for c in tree if tree[c]}


@torch.no_grad()
def calibrated(model: torch.nn.Module, run, seed: int) -> dict:
    """``model``'s variables after ``run()`` (a training-mode forward) at
    BatchNorm momentum 0, each running variance then raised by U(0.5, 1.5):
    the running means are the batch's, as a trained model's are of its
    data, and no channel divides by the root of a variance near 0 (a dead
    channel's), which would amplify float32 roundings by up to 1/√eps.
    Seeded statistics instead let activations grow to the hundreds through
    50 blocks, where float32 cancellation alone exceeds the taps' bar."""
    rng = np.random.default_rng(seed)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm32)]
    momenta = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 0.0
    run()
    for bn, m in zip(bns, momenta):
        bn.momentum = m
        bn.running_var += torch.from_numpy(rng.uniform(0.5, 1.5, bn.running_var.shape)
                                           .astype(np.float32))
    return to_flax(model)


def backbone_variables(name: str, seed: int = 0) -> tuple[torch.nn.Module, dict]:
    """The port's backbone (eval mode) holding numpy-seeded variables, its
    BatchNorm statistics calibrated on a seeded batch."""
    with torch.device("meta"):
        net = backbone(name)
    net = net.to_empty(device="cpu").eval()
    net.load_state_dict(from_flax(seeded(to_flax(net), seed)), strict=True)
    x = torch.from_numpy(images(2, S, seed=100 + seed)).permute(0, 3, 1, 2)
    variables = calibrated(net, lambda: net(x, train=True), seed)
    return net, {c: v for c, v in variables.items() if v}


def images(n: int, size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(TAPS))
def test_registry_resolves_every_name(name):
    """All eleven names of the JAX registry resolve to a module whose
    ``tap_channels`` are JAX's tap channels (tests/test_backbones.py) and
    whose taps come out at strides 8/16/32 with them (shapes only, on the
    meta device); each keeps its own BatchNorm momentum unless one is given."""
    with torch.device("meta"):
        net = backbone(name)
        out = net(torch.empty(2, 3, S, S))
        moved = backbone(name, bn_momentum=0.9)
    assert net.tap_channels == TAPS[name]
    assert [tuple(t.shape) for t in out] == [(2, c, S // s, S // s)
                                            for c, s in zip(TAPS[name], (8, 16, 32))]
    default = {"mob": 0.999, "res": 0.99, "den": 0.99, "vgg": None}[name[:3]]
    momenta = {m.momentum for m in net.modules() if isinstance(m, BatchNorm32)}
    assert momenta == (set() if default is None else {default})
    assert {m.momentum for m in moved.modules() if isinstance(m, BatchNorm32)} == \
        (set() if default is None else {0.9})


@pytest.mark.parametrize("name", ["alexnet", "resnet34", "vgg11", "densenet100", "resnet"])
def test_unknown_backbone_raises(name):
    with pytest.raises(ValueError, match="unknown backbone"):
        backbone(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_flax_tree_names_and_shapes(name):
    """The port's parameter tree (``to_flax``) is the Flax module's, path for
    path and shape for shape (``jax.eval_shape`` of its ``init``)."""
    net = backbone(name)
    want = jax.eval_shape(lambda x: jx_backbone(name).init(jax.random.PRNGKey(0), x),
                          jnp.zeros((1, S, S, 3)))
    got = to_flax(net)
    assert {c for c in got if got[c]} == set(want)
    for c in want:
        assert {k: v.shape for k, v in flat(got[c]).items()} == \
            {k: v.shape for k, v in flat(want[c]).items()}, c


# ---------------------------------------------------------------------------
# C3/C4/C5
# ---------------------------------------------------------------------------
def jax_taps(name, variables, x, train=False):
    """JAX's taps (and updated statistics), jitted: un-jitted, each distinct
    shape of DenseNet's compiles on its own (~26 s for DenseNet-121)."""
    model = jx_backbone(name)
    fn = lambda v, x: model.apply(v, x, train=train, mutable=["batch_stats"] if train else False)
    out = jax.jit(fn)(variables, jnp.asarray(x))
    if train:
        out, mut = out
        return [np.asarray(t) for t in out], flat(mut.get("batch_stats", {}))
    return [np.asarray(t) for t in out], None


@pytest.mark.parametrize("name", NEW)
def test_inference_taps_match_jax(name):
    """C3/C4/C5 in inference (running statistics), batch 2 at 64², float32:
    within atol 2e-4 + rtol 1e-3 of JAX's. A bar ten times tighter holds:
    the largest error seen is 5.4 % of this one (VGG19's C4; ResNet-152's
    3.8 %, DenseNet's 0.4 %)."""
    net, variables = backbone_variables(name)
    x = images(2, S, seed=1)
    want, _ = jax_taps(name, variables, x)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for tap, w, g in zip(("C3", "C4", "C5"), want, got):
        np.testing.assert_allclose(nhwc(g), w, atol=ATOL, rtol=RTOL, err_msg=f"{name} {tap}")


@pytest.mark.parametrize("name", FAMILIES)
def test_training_mode_taps_and_statistics_match_jax(name):
    """Training mode (batch statistics, running ones updated at momentum
    0.99, VGG with none), batch 2 at 64²: each tap within relative L2 2e-3
    of JAX's, every updated running mean and variance within rtol 1e-4,
    atol 1e-5. Elementwise the taps miss the inference bar: at C5 a channel
    has 8 samples, some batch variances are near 0, and normalizing by them
    amplifies float32 roundings (ResNet-50's C5: JAX's taps stray 3.9e-4 in
    relative L2 from a float64 evaluation of the same function, the port's
    1.3e-4; VGG, without BatchNorm, agrees to 2e-6)."""
    net, variables = backbone_variables(name)
    x = images(2, S, seed=2)
    want, want_stats = jax_taps(name, variables, x, train=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    for tap, w, g in zip(("C3", "C4", "C5"), want, got):
        assert np.linalg.norm(nhwc(g) - w) <= 2e-3 * np.linalg.norm(w), (name, tap)
    stats = flat(to_flax(net)["batch_stats"])
    assert stats.keys() == want_stats.keys()
    assert (len(stats) == 0) == name.startswith("vgg")
    for k, w in want_stats.items():
        assert not np.array_equal(stats[k], flat(variables["batch_stats"])[k]), k
        np.testing.assert_allclose(stats[k], w, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["vgg16", "densenet121"])
def test_empty_extents_give_jax_shapes(name):
    """At 16² C5 pools to an empty map (VGG's 2×2 max pool, DenseNet's
    average pool, of a 1² map): the taps have the shapes of JAX's
    (``jax.eval_shape`` of its ``apply``)."""
    net, variables = backbone_variables(name)
    x = images(1, 16, seed=3)
    want = jax.eval_shape(lambda v, x: jx_backbone(name).apply(v, x), variables,
                          jnp.asarray(x))
    with torch.no_grad():
        got = [nhwc(t) for t in net(torch.from_numpy(x).permute(0, 3, 1, 2))]
    assert [g.shape for g in got] == [tuple(w.shape) for w in want]
    assert got[2].size == 0 and got[1].shape[1:3] == (1, 1)


