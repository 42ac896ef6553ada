"""The port's baseline models against the JAX package's, on the CPU in fp32.

Each backbone's ``BaselineModel`` gets the JAX module's initial variables
through ``load_baseline_variables`` and is held against it at 32 px:
``features`` and ``cls_logits`` within 1e-4 of their largest magnitude in
eval mode and in train mode (VGG-16's dropout mask taken from the JAX run),
the running statistics after the train-mode call within 1e-5 of the JAX
``batch_stats``. The JAX compiles are kept short with the constructor
arguments the JAX classes expose: ResNet-50 with one bottleneck a stage,
EfficientNet-B0 and MobileNetV3-Large on block subsets (stride 2, residual,
SE on and off, relu and hard-swish), Swin on two stages (32 px runs window
4 with a shift); VGG-16 and DeiT-Tiny whole. Also: the BatchNorm against
``flax.linen.BatchNorm`` (the biased variance in the running statistics),
the converter's round trip bit for bit, the six parameter counts at 224 px
against ``jax.eval_shape`` (the port's modules on the ``meta`` device), the
init statistics against flax's, every Swin parameter's gradient, and the
refusal of a bf16 or fused-block build of a backbone other than DeiT.
"""
from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rovit_kan_tpu.models.baselines as JB
from rovit_kan_tpu_torch.models import baselines as PB
from rovit_kan_tpu_torch.models.convert import (
    load_baseline_variables,
    to_baseline_variables,
)

SIZE, BATCH = 32, 8
EFF_BLOCKS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 1, 2, 5))
MBV_BLOCKS = ((3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
              (5, 72, 40, True, "relu", 2), (5, 120, 40, True, "relu", 1),
              (3, 240, 80, False, "hswish", 2),
              (3, 480, 112, True, "hswish", 1))
# name -> (class name, constructor arguments of both packages' class)
CASES = {
    "resnet_test": ("ResNet50", {"stage_sizes": (1, 1, 1, 1)}),
    "effnet_test": ("EfficientNetB0", {"blocks": EFF_BLOCKS}),
    "mbv3_test": ("MobileNetV3Large", {"blocks": MBV_BLOCKS}),
    "vgg16": ("VGG16", {}),
    "swin_test": ("SwinTiny", {"depths": (2, 2), "heads": (3, 6)}),
    "deit_tiny": ("DeiTTinyClassifier", {}),
}
PUBLISHED = ["deit_tiny", "resnet50", "efficientnet_b0", "mobilenetv3_large",
             "vgg16", "swin_tiny"]


@pytest.fixture(scope="module", autouse=True)
def registered():
    """The test backbones in both registries, taken out after."""
    added = [n for n in CASES if n not in JB.BACKBONES]
    for n in added:
        cls, kw = CASES[n]
        JB.BACKBONES[n] = partial(getattr(JB, cls), **kw)
        PB.BACKBONES[n] = partial(getattr(PB, cls), **kw)
    yield
    for n in added:
        JB.BACKBONES.pop(n)
        PB.BACKBONES.pop(n)


def _images(seed=0):
    return np.random.RandomState(seed).randn(BATCH, SIZE, SIZE, 3) \
        .astype(np.float32)


_JAX_RUNS = {}


def jax_run(name):
    """The JAX model's initial variables, its eval-mode outputs, its
    train-mode outputs with the updated ``batch_stats``, and the dropout
    outputs it captured: one compile a backbone, cached for the module."""
    if name not in _JAX_RUNS:
        model = JB.BaselineModel(backbone_name=name, num_classes=4)

        @jax.jit
        def run(x):
            v = model.init(jax.random.PRNGKey(0), x)
            ev = model.apply(v, x)
            tr, mut = model.apply(
                v, x, deterministic=False,
                mutable=["batch_stats", "intermediates"],
                rngs={"dropout": jax.random.PRNGKey(1)},
                capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout))
            return v, ev, tr, mut

        out = jax.device_get(run(jnp.asarray(_images())))
        _JAX_RUNS[name] = jax.tree.map(np.asarray, out)
    return _JAX_RUNS[name]


def port_model(name, variables=None):
    model = PB.BaselineModel(name, 4, image_size=SIZE)
    if variables is not None:
        load_baseline_variables(model, variables, device="cpu")
    return model


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name, monkeypatch):
    v, ev, tr, mut = jax_run(name)
    model = port_model(name, v).eval()
    x = torch.from_numpy(_images())
    with torch.no_grad():
        out = model(x)
    for k in ("features", "cls_logits"):
        assert rel_err(out[k].numpy(), ev[k]) < 1e-4, k
    if name == "vgg16":
        # The JAX run's dropout mask, as its kept outputs show it.
        kept = torch.from_numpy(
            jax.tree.leaves(mut["intermediates"])[0] != 0)
        monkeypatch.setattr(PB, "dropout",
                            lambda y, p, training, g: y * kept / (1 - p))
    model.train()
    with torch.no_grad():
        out = model(x)
    for k in ("features", "cls_logits"):
        assert rel_err(out[k].numpy(), tr[k]) < 1e-4, k
    stats = to_baseline_variables(model).get("batch_stats")
    assert (stats is None) == ("batch_stats" not in mut)
    if stats is not None:
        got, want = jax.tree.leaves(stats), jax.tree.leaves(
            mut["batch_stats"])
        assert jax.tree.structure(stats) == jax.tree.structure(
            mut["batch_stats"])
        assert max(float(np.abs(a - b).max())
                   for a, b in zip(got, want)) < 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_variables_round_trip(name):
    v = jax_run(name)[0]
    model = port_model(name)
    PB.init_baseline_weights(model, seed=3)
    tree = to_baseline_variables(model)
    assert jax.tree.structure(tree) == jax.tree.structure(v)
    back = load_baseline_variables(port_model(name), tree, device="cpu")
    for (k, a), (k2, b) in zip(model.state_dict().items(),
                               back.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    # And JAX -> port -> JAX.
    again = to_baseline_variables(port_model(name, v))
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(v)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_init_statistics_match_flax(name):
    v = jax_run(name)[0]
    model = port_model(name)
    PB.init_baseline_weights(model, seed=0)
    mine = jax.tree_util.tree_leaves_with_path(to_baseline_variables(model))
    theirs = dict(jax.tree_util.tree_leaves_with_path(v))
    for path, a in mine:
        b = theirs[path]
        where = jax.tree_util.keystr(path)
        assert a.shape == b.shape, where
        if not b.any() or np.all(b == 1.0):
            np.testing.assert_array_equal(a, b, err_msg=where)
        elif b.size >= 1000:
            assert abs(a.std() / b.std() - 1) < 0.1, where
            assert abs(a.mean()) < 0.1 * a.std() + 1e-3, where


@pytest.mark.parametrize("name", PUBLISHED)
def test_parameter_counts_at_224(name):
    jax_model = JB.BaselineModel(backbone_name=name, num_classes=4)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        model = PB.BaselineModel(name, 4, image_size=224)
    assert sum(p.numel() for p in model.parameters()) == want
    # The published widths re-headed to 4 classes
    # (tests/test_baselines_extra.py, outputs/baselines/*.json).
    assert want == {"deit_tiny": 5_525_188, "resnet50": 23_516_228,
                    "efficientnet_b0": 4_012_672,
                    "mobilenetv3_large": 4_205_322,
                    "vgg16": 134_276_932, "swin_tiny": 27_522_430}[name]


@pytest.mark.parametrize("name", [n for n in PUBLISHED if n != "deit_tiny"])
def test_only_deit_takes_another_dtype(name):
    """The convnets and Swin compute in fp32 only: a bf16 or fused-block
    build is refused, not run in fp32 under another name."""
    with torch.device("meta"):
        for kw in ({"dtype": torch.bfloat16}, {"use_fused_block": True}):
            with pytest.raises(ValueError, match="deit_tiny only"):
                PB.BaselineModel(name, 4, image_size=224, **kw)
        PB.BaselineModel("deit_tiny", 4, torch.bfloat16, True,
                         image_size=224)


def test_batchnorm_matches_flax():
    """One train-mode call on a batch whose channels sit far from zero: the
    output and the running statistics of flax's BatchNorm. An unbiased
    running variance (``nn.BatchNorm2d``'s) would be 8/7 of it here."""
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 2, 2, 6) * rng.uniform(0.5, 2, 6)
         + rng.uniform(-3, 3, 6)).astype(np.float32)          # NHWC
    flax_bn = fnn.BatchNorm(momentum=0.9, dtype=jnp.float32)
    v = {"params": {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 6),
                                         jnp.float32),
                    "bias": jnp.asarray(rng.randn(6), jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(rng.randn(6), jnp.float32),
                         "var": jnp.asarray(rng.uniform(0.5, 2, 6),
                                            jnp.float32)}}
    y, mut = flax_bn.apply(v, x, use_running_average=False,
                           mutable=["batch_stats"])
    bn = PB.BatchNorm(6)
    with torch.no_grad():
        for t, a in ((bn.weight, v["params"]["scale"]),
                     (bn.bias, v["params"]["bias"]),
                     (bn.running_mean, v["batch_stats"]["mean"]),
                     (bn.running_var, v["batch_stats"]["var"])):
            t.copy_(torch.tensor(np.asarray(a)))
        got = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), y,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               mut["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               mut["batch_stats"]["var"], atol=1e-5)
    unbiased = 0.9 * np.asarray(v["batch_stats"]["var"]) \
        + 0.1 * x.reshape(-1, 6).var(0, ddof=1)
    assert np.abs(unbiased - mut["batch_stats"]["var"]).max() > 1e-2
    with torch.no_grad():
        evald = bn.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    y_eval = flax_bn.apply(mut | {"params": v["params"]}, x,
                           use_running_average=True)
    np.testing.assert_allclose(evald.permute(0, 2, 3, 1).numpy(), y_eval,
                               atol=1e-5)


def test_swin_constants_match_jax():
    for ws in (2, 4, 7):
        np.testing.assert_array_equal(PB._rel_pos_index(ws),
                                      JB._rel_pos_index(ws))
    for H, ws, shift in ((8, 4, 2), (56, 7, 3), (28, 7, 3)):
        np.testing.assert_array_equal(PB._shift_mask(H, H, ws, shift),
                                      JB._shift_mask(H, H, ws, shift))
    # 224 px: a window of 7 at every stage, shifts on the odd blocks of the
    # first three stages (the last stage's side is one window).
    with torch.device("meta"):
        swin = PB.SwinTiny(image_size=224)
    blocks = [(n, getattr(swin, n)) for n in swin.names if "block" in n]
    assert all(b.ws == 7 for _, b in blocks)
    assert [n for n, b in blocks if b.shift] == [
        "stage0_block1", "stage1_block1", "stage2_block1", "stage2_block3",
        "stage2_block5"]
    small = PB.SwinTiny(depths=(2, 2), heads=(3, 6), image_size=SIZE)
    assert (small.stage0_block1.ws, small.stage0_block1.shift) == (4, 2)


def test_every_swin_parameter_gets_a_gradient():
    model = port_model("swin_test")
    PB.init_baseline_weights(model, seed=1)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, SIZE, SIZE, 3)
                         .astype(np.float32))
    (model(x)["cls_logits"] ** 2).mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
