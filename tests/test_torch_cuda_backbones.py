"""The ResNet, VGG and DenseNet backbones and the Keras ``.h5`` import on the
CUDA card: each new backbone's float32 C3/C4/C5 (TF32 off) against the CPU
route on the same seeded weights, and the golden Keras MobileNetV2 file read
by the port's own HDF5 reader (which needs no ``h5py``) and imported into a
backbone whose taps hold Keras' activations. Needs a CUDA
card: every test here skips on a machine without one. On the card (which has
no JAX, so the JAX-side conftest is skipped):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_backbones.py
"""

import copy
import pathlib

import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_torch.models.backbones import backbone
from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import MobileNetV2Backbone
from fpn_mt_image_captioning_torch.models.layers import BatchNorm32
from fpn_mt_image_captioning_torch.utils.weight_import import import_retinanet_weights
from fpn_mt_image_captioning_torch.weights import from_flax, init_weights, to_flax

pytestmark = pytest.mark.cuda
GOLDEN = pathlib.Path(__file__).parent / "golden"
NAMES = ["resnet50", "resnet101", "resnet152", "vgg16", "vgg19", "densenet121",
         "densenet169", "densenet201"]
SIZE = 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@torch.no_grad()
def seeded(name: str, seed: int = 0) -> torch.nn.Module:
    """``name``'s backbone on the CPU with seeded weights, its BatchNorm
    statistics calibrated on a seeded batch (training-mode pass at momentum
    0, running variances raised by U(0.5, 1.5)) so that activations stay of
    the order of 1 through every block, as a trained model's do."""
    net = backbone(name)
    init_weights(net, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    bns = [m for m in net.modules() if isinstance(m, BatchNorm32)]
    for bn in bns:
        bn.momentum = 0.0
    net(torch.rand(2, 3, SIZE, SIZE, generator=g) * 2 - 1, train=True)
    for bn in bns:
        bn.momentum = 0.99
        bn.running_var += 0.5 + torch.rand(bn.running_var.shape, generator=g)
    return net.eval()


@pytest.mark.parametrize("name", NAMES)
def test_taps_on_the_card_match_the_cpu(dev, name):
    """float32, batch 2 at 128²: every tap element within atol 2e-4 + rtol
    1e-3 of the CPU route's (the JAX package's bar for backbone taps)."""
    net = seeded(name)
    x = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(5)) * 2 - 1
    with torch.no_grad():
        want = net(x)
        got = copy.deepcopy(net).to(dev)(x.to(dev))
    for tap, g, w in zip(("C3", "C4", "C5"), got, want):
        torch.testing.assert_close(g.cpu(), w, atol=2e-4, rtol=1e-3, msg=f"{name} {tap}")


def test_golden_h5_imports_on_the_card(dev):
    """The golden Keras MobileNetV2 (alpha 0.35) ``.h5`` through the port's
    reader and ``import_retinanet_weights`` into a backbone on the card:
    C3/C4/C5 within atol 2e-4 + rtol 1e-3 of Keras' own activations."""
    golden = np.load(GOLDEN / "mobilenet_v2_a035_golden.npz")
    net = MobileNetV2Backbone(alpha=float(golden["alpha"]))
    tree = to_flax(net)
    wrap = lambda t: {"encoder": {"feature_extractor": {"backbone": t, "fpn": {}}}}
    imported, report = import_retinanet_weights(
        {c: wrap(tree[c]) for c in ("params", "batch_stats")},
        str(GOLDEN / "mobilenet_v2_a035.h5"))
    assert len(report.matched) == 260
    net.load_state_dict(from_flax(
        {c: imported[c]["encoder"]["feature_extractor"]["backbone"] for c in imported}))
    net = net.to(dev).eval()
    with torch.no_grad():
        taps = net(torch.as_tensor(golden["x"], device=dev).permute(0, 3, 1, 2))
    for tap, t in zip(("C3", "C4", "C5"), taps):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).cpu().numpy(), golden[tap],
                                   atol=2e-4, rtol=1e-3, err_msg=tap)
