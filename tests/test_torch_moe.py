"""The port's expert-choice MoE FFN and remat against the JAX modules.

``MoEMlp`` (``models/moe.py``) on the same weights and inputs (seeded
numpy) as the JAX ``MoEMlp``: ``expert_capacity`` over a grid; the selected
token sets exactly equal, a single expert's ties (every probability 1.0)
included, where JAX's ``top_k`` takes the lowest indices; outputs within
1e-5 of the largest output magnitude in fp32 (the 197-token layer's
768-term sums part by 1.2e-5 at a largest output of 3.0) and within two
bf16 ulps of it in bf16 (both sides round the FFN's operands to bf16 and
sum in fp32, so they part only where an fp32 sum crosses a bf16 rounding
boundary of the output; the JAX side's einsums run with their bf16
operands widened to fp32, ``_widened_einsum``); one expert at full
capacity is the dense ``Mlp``; every gradient against ``jax.vjp`` within
1e-5 of its largest magnitude (fp32); the lecun_normal init over each
expert's own fan-in. The MoE RoViTKAN (depth 4, d = 32, E = 4) against the
JAX model at 2e-5, six unfused AdamW steps against the JAX
``make_train_step`` (losses 1e-4, gradients 1e-3 of each parameter's
largest magnitude, final parameters 2e-5), the ``moe`` leaves through
``load_jax_params`` / ``to_jax_params``, and the flagship's count with
eight experts against ``jax.eval_shape`` of the JAX model. Remat: the same
gradient bits on and off, and within 1e-4 of each gradient's largest
magnitude of the JAX model built with ``remat=True``. ``cli.train
--moe_experts``, ``cli.evaluate`` and ``load_engine`` rebuild the MoE model
from the sidecar.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovit_kan_tpu.config import Config as JaxConfig
from rovit_kan_tpu.models.moe import MoEMlp as JaxMoEMlp
from rovit_kan_tpu.models.moe import expert_capacity as jax_capacity
from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.models.rovit_kan import build_model as jax_build_model
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.convert import (
    _jax_path,
    load_jax_params,
    to_jax_params,
)
from rovit_kan_tpu_torch.models.moe import MoEMlp, expert_capacity, route
from rovit_kan_tpu_torch.models.rovit_kan import (
    RoViTKAN,
    build_model,
    count_parameters,
    init_weights,
)
from rovit_kan_tpu_torch.models.vit import Mlp, VisionTransformer
from test_torch_train_step import STAGES, assert_params_match, run_pair

MODEL_KW = dict(embed_dim=32, depth=4, num_heads=2, image_size=32,
                patch_size=16, kan_layers=(32, 8, 1), hidden_dim=16,
                moe_experts=4, moe_every=2)
# (B, S, D, H, E, capacity factor)
LAYERS = [(2, 17, 32, 64, 4, 2.0), (2, 197, 192, 768, 8, 2.0)]
LAYER_IDS = ["17x32-E4", "197x192-E8"]


def _layer_params(D, H, E, seed):
    """A JAX ``MoEMlp`` param tree with every leaf drawn (biases too)."""
    rng = np.random.RandomState(seed)
    return {"gate": {"kernel": rng.normal(0, 1.0, (D, E)).astype(np.float32)},
            "w1": rng.normal(0, D ** -0.5, (E, D, H)).astype(np.float32),
            "b1": rng.normal(0, 0.1, (E, H)).astype(np.float32),
            "w2": rng.normal(0, H ** -0.5, (E, H, D)).astype(np.float32),
            "b2": rng.normal(0, 0.1, (E, D)).astype(np.float32)}


def _port_layer(p, cf, dtype=torch.float32):
    E, D, H = p["w1"].shape
    layer = MoEMlp(D, H, E, cf, dtype)
    with torch.no_grad():
        layer.gate.weight.copy_(torch.from_numpy(p["gate"]["kernel"].T))
        for k in ("w1", "b1", "w2", "b2"):
            getattr(layer, k).copy_(torch.from_numpy(p[k]))
    return layer


def _x(B, S, D, seed):
    return np.random.RandomState(seed).normal(0, 1, (B, S, D)).astype(
        np.float32)


def _jax_selection(p, x, C):
    """The token indices the JAX layer's ``top_k`` picks, per (b, e)."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["gate"]["kernel"]),
                           axis=-1)
    return np.asarray(jax.lax.top_k(probs.transpose(0, 2, 1), C)[1])


def test_expert_capacity_matches_jax():
    for S in (1, 4, 17, 50, 197, 577):
        for E in (1, 2, 3, 4, 8, 100):
            for cf in (0.01, 0.25, 0.5, 1.0, 1.25, 2.0, 4.0, 100.0):
                assert expert_capacity(S, E, cf) == jax_capacity(S, E, cf)


@pytest.mark.parametrize("B,S,D,H,E,cf", LAYERS, ids=LAYER_IDS)
def test_selection_matches_jax(B, S, D, H, E, cf):
    p = _layer_params(D, H, E, seed=S)
    x = _x(B, S, D, seed=S + 1)
    C = expert_capacity(S, E, cf)
    want = _jax_selection(p, x, C)
    gate = torch.from_numpy(p["gate"]["kernel"].T)
    idx, w = route(torch.from_numpy(x), gate, C)
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1),
                                  np.sort(want, -1))
    assert w.dtype == torch.float32


@pytest.mark.parametrize("S,cf", [(197, 0.25), (17, 0.5), (6, 1.0)])
def test_single_expert_ties_pick_the_lowest_tokens(S, cf):
    """One expert: every gate probability is 1.0, so JAX's ``top_k`` takes
    tokens 0..C-1; the port's stable sort takes the same."""
    p = _layer_params(8, 16, 1, seed=3)
    x = _x(1, S, 8, seed=4)
    C = expert_capacity(S, 1, cf)
    want = _jax_selection(p, x, C)
    np.testing.assert_array_equal(want[0, 0], np.arange(C))
    gate = torch.from_numpy(p["gate"]["kernel"].T)
    idx, w = route(torch.from_numpy(x), gate, C)
    np.testing.assert_array_equal(idx.numpy(), want)
    assert torch.all(w == 1.0)


_einsum = jnp.einsum


def _widened_einsum(*args, preferred_element_type=None, **kw):
    """``jnp.einsum`` with its operands widened to fp32 where it asks for
    an fp32 result. XLA's CPU runtime has no bf16 x bf16 -> fp32 dot; the
    widened one has the same products (a product of two bf16 numbers is
    exact in fp32) and sums them in fp32, as the card's would."""
    if preferred_element_type == jnp.float32:
        args = [a.astype(jnp.float32) if hasattr(a, "astype") else a
                for a in args]
    return _einsum(*args, preferred_element_type=preferred_element_type,
                   **kw)


def _jax_forward(p, x, cf, dtype):
    E, D, H = p["w1"].shape
    m = JaxMoEMlp(D, H, num_experts=E, capacity_factor=cf, dtype=dtype)
    with mock.patch.object(jnp, "einsum", _widened_einsum):
        return np.asarray(m.apply({"params": p}, jnp.asarray(x)),
                          np.float32)


@pytest.mark.parametrize("B,S,D,H,E,cf", LAYERS, ids=LAYER_IDS)
def test_forward_matches_jax_fp32(B, S, D, H, E, cf):
    p = _layer_params(D, H, E, seed=S)
    x = _x(B, S, D, seed=S + 1)
    want = _jax_forward(p, x, cf, jnp.float32)
    got = _port_layer(p, cf)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("B,S,D,H,E,cf", LAYERS, ids=LAYER_IDS)
def test_forward_matches_jax_bf16(B, S, D, H, E, cf):
    p = _layer_params(D, H, E, seed=S)
    x = _x(B, S, D, seed=S + 1)
    want = _jax_forward(p, x, cf, jnp.bfloat16)
    got = _port_layer(p, cf, torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    top = float(np.abs(want).max())
    tol = 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=tol,
                               rtol=0)


N_VALID = [(2, 8, 16, 32, 4, 2.0, 6), (2, 198, 192, 768, 8, 2.0, 197)]


@pytest.mark.parametrize("B,S,D,H,E,cf,n_valid", N_VALID,
                         ids=["8-of-6", "198-of-197"])
def test_n_valid_matches_jax(B, S, D, H, E, cf, n_valid):
    """Sequence-parallel filler (``n_valid``): the chosen sets exactly the
    JAX layer's (its ``top_k`` over the gate scores with the filler at
    -inf), no filler token chosen, the outputs 1e-5 of their largest, and
    the real rows the layer's outputs without the filler (the JAX test's
    contract, ``tests/test_moe.py``)."""
    p = _layer_params(D, H, E, seed=S)
    x = _x(B, S, D, seed=S + 1)
    x[:, n_valid:] = 3.0
    C = expert_capacity(n_valid, E, cf)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["gate"]["kernel"]),
                           axis=-1).transpose(0, 2, 1)
    masked = jnp.where(jnp.arange(S) < n_valid, probs, -jnp.inf)
    want_idx = np.asarray(jax.lax.top_k(masked, C)[1])
    gate = torch.from_numpy(p["gate"]["kernel"].T)
    idx, w = route(torch.from_numpy(x), gate, C, n_valid)
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1),
                                  np.sort(want_idx, -1))
    assert int(idx.max()) < n_valid and torch.isfinite(w).all()
    m = JaxMoEMlp(D, H, num_experts=E, capacity_factor=cf)
    want = np.asarray(m.apply({"params": p}, jnp.asarray(x), n_valid))
    layer = _port_layer(p, cf)
    got = layer(torch.from_numpy(x), n_valid=n_valid).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    alone = layer(torch.from_numpy(x[:, :n_valid])).detach().numpy()
    np.testing.assert_allclose(got[:, :n_valid], alone, rtol=0,
                               atol=1e-6 * np.abs(alone).max())


def test_single_expert_full_capacity_is_the_dense_mlp():
    p = _layer_params(16, 32, 1, seed=5)
    x = torch.from_numpy(_x(2, 6, 16, seed=6))
    dense = Mlp(16, 32)
    with torch.no_grad():
        dense.fc1.weight.copy_(torch.from_numpy(p["w1"][0].T))
        dense.fc1.bias.copy_(torch.from_numpy(p["b1"][0]))
        dense.fc2.weight.copy_(torch.from_numpy(p["w2"][0].T))
        dense.fc2.bias.copy_(torch.from_numpy(p["b2"][0]))
    torch.testing.assert_close(_port_layer(p, 1.0)(x), dense(x), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("B,S,D,H,E,cf", LAYERS, ids=LAYER_IDS)
def test_gradients_match_jax_vjp(B, S, D, H, E, cf):
    p = _layer_params(D, H, E, seed=S)
    x = _x(B, S, D, seed=S + 1)
    g = np.random.RandomState(7).normal(0, 1, (B, S, D)).astype(np.float32)
    m = JaxMoEMlp(D, H, num_experts=E, capacity_factor=cf)
    _, vjp = jax.vjp(lambda p, x: m.apply({"params": p}, x),
                     jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(g))
    layer = _port_layer(p, cf)
    xt = torch.from_numpy(x).requires_grad_()
    layer(xt).backward(torch.from_numpy(g))
    pairs = [(xt.grad, jx), (layer.gate.weight.grad.T, jp["gate"]["kernel"])]
    pairs += [(getattr(layer, k).grad, jp[k])
              for k in ("w1", "b1", "w2", "b2")]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_moe_every_below_one_raises():
    with pytest.raises(ValueError, match="moe_every"):
        VisionTransformer(image_size=32, embed_dim=32, depth=2, num_heads=2,
                          moe_experts=4, moe_every=0)
    cfg = Config()
    cfg.model.moe_experts, cfg.model.moe_every = 4, 0
    with pytest.raises(ValueError, match="moe_every"):
        build_model(cfg, device="cpu")


def test_init_draws_each_expert_from_its_own_fan_in():
    """lecun_normal with ``batch_axis=0``: std 1/sqrt(D) for w1 and
    1/sqrt(H) for w2 per expert (within 5% over 147k draws), zero biases,
    the gate 1/sqrt(D)."""
    model = RoViTKAN(**dict(MODEL_KW, embed_dim=192, num_heads=3,
                            kan_layers=(192, 8, 1), moe_experts=8))
    init_weights(model, seed=0)
    moe = model.backbone.model.blocks[1].moe
    for e in range(8):
        assert abs(float(moe.w1[e].detach().std()) * 192 ** 0.5 - 1) < 0.05
        assert abs(float(moe.w2[e].detach().std()) * 768 ** 0.5 - 1) < 0.05
    assert abs(float(moe.gate.weight.detach().std()) * 192 ** 0.5 - 1) < 0.1
    assert not moe.b1.any() and not moe.b2.any()
    assert moe.gate.bias is None


@pytest.fixture(scope="module")
def jax_moe_params():
    m = JaxRoViTKAN(**MODEL_KW)
    params = jax.jit(m.init)(jax.random.PRNGKey(0),
                             np.zeros((1, 32, 32, 3), np.float32))["params"]
    rng = np.random.RandomState(0)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), params)


def _images(seed=1, n=4):
    return np.random.RandomState(seed).normal(0, 1, (n, 32, 32, 3)).astype(
        np.float32)


def test_moe_model_matches_jax(jax_moe_params):
    bb = jax_moe_params["backbone"]
    assert "moe" in bb["blocks_1"] and "moe" in bb["blocks_3"]
    assert "mlp" in bb["blocks_0"] and "mlp" in bb["blocks_2"]
    images = _images()
    want = jax.jit(JaxRoViTKAN(**MODEL_KW).apply)(
        {"params": jax_moe_params}, jnp.asarray(images))
    model = load_jax_params(RoViTKAN(**MODEL_KW), jax_moe_params,
                            device="cpu").eval()
    blocks = model.backbone.model.blocks
    assert [hasattr(b, "moe") for b in blocks] == [False, True, False, True]
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    for k in ("features", "cls_logits", "ordinal_logits", "mu", "log_var",
              "kan_severity"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-5, rtol=0, err_msg=k)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_moe_leaves_round_trip(jax_moe_params):
    model = load_jax_params(RoViTKAN(**MODEL_KW), jax_moe_params,
                            device="cpu")
    moe = model.backbone.model.blocks[1].moe
    np.testing.assert_array_equal(
        moe.gate.weight.detach().numpy().T,
        jax_moe_params["backbone"]["blocks_1"]["moe"]["gate"]["kernel"])
    assert _jax_path("backbone.model.blocks.1.moe.gate.weight", 2) == (
        ("backbone", "blocks_1", "moe", "gate", "kernel"), True)
    assert _jax_path("backbone.model.blocks.1.moe.w1", 3) == (
        ("backbone", "blocks_1", "moe", "w1"), False)
    back = dict(_flat(to_jax_params(model)))
    want = dict(_flat(jax_moe_params))
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))


def test_moe_train_steps_match_jax():
    """Six unfused AdamW steps (stages 1, 2, 3, 4, 4, 4) on the train-step
    harness's model with block 1 sparse (E = 4)."""
    moe = dict(moe_experts=4, moe_every=2)
    jlosses, tlosses, jparams, model = run_pair(len(STAGES), fused=False,
                                                model_kw=moe)
    assert hasattr(model.backbone.model.blocks[1], "moe")
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=1e-4)
    assert_params_match(model, jparams)


def test_flagship_moe_parameter_count():
    cfg = Config()
    cfg.model.moe_experts = 8
    model = build_model(cfg, inference=True, device="cpu")
    assert count_parameters(model)["total"] == 18_142_234
    jcfg = JaxConfig()
    jcfg.model.moe_experts = 8
    shapes = jax.eval_shape(jax_build_model(jcfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))["params"]
    assert sum(int(np.prod(a.shape))
               for a in jax.tree.leaves(shapes)) == 18_142_234


def _grads(model, images, seed=0):
    model.zero_grad()
    out = model(torch.from_numpy(images))
    g = np.random.RandomState(seed)
    loss = sum((out[k] * torch.from_numpy(g.normal(0, 1, out[k].shape)
                                          .astype(np.float32))).sum()
               for k in ("cls_logits", "ordinal_logits", "mu", "log_var",
                         "kan_severity"))
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("moe_experts", [0, 4], ids=["dense", "moe"])
def test_remat_gives_the_same_gradients(jax_moe_params, moe_experts):
    """Remat on and off: the same gradient bits, and both against
    ``jax.grad`` of the JAX model built with ``remat=True``, within 1e-4 of
    each gradient's largest magnitude (the gate's parts by 1.1e-5 of its
    own; the train-step harness holds 1e-3)."""
    kw = dict(MODEL_KW, moe_experts=moe_experts, dropout=0.0)
    jm = JaxRoViTKAN(**kw, remat=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              np.zeros((1, 32, 32, 3), np.float32))["params"]
    rng = np.random.RandomState(2)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), params)
    images = _images(seed=3)
    grads = {}
    for remat in (False, True):
        model = load_jax_params(RoViTKAN(**kw, remat=remat), params,
                                device="cpu")
        assert model.backbone.model.remat == remat
        grads[remat] = _grads(model, images)
    for name, g in grads[False].items():
        assert torch.equal(g, grads[True][name]), name

    g = np.random.RandomState(0)
    heads = ("cls_logits", "ordinal_logits", "mu", "log_var", "kan_severity")
    outs = jax.eval_shape(jm.apply, {"params": params}, jnp.asarray(images))
    cot = {k: g.normal(0, 1, outs[k].shape).astype(np.float32)
           for k in heads}

    def loss(p):
        o = jm.apply({"params": p}, jnp.asarray(images), deterministic=True)
        return sum((o[k] * cot[k]).sum() for k in heads)

    jgrads = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params))
    for name, got in grads[True].items():
        path, transpose = _jax_path(name, got.dim())
        want = jgrads
        for key in path:
            want = want[key]
        want = np.asarray(want)
        got = got.numpy()
        np.testing.assert_allclose(got.T if transpose else got, want,
                                   rtol=0, atol=1e-4 * max(
                                       np.abs(want).max(), 1e-12),
                                   err_msg=name)


def test_moe_trains_evaluates_and_serves_through_the_clis(tmp_path):
    """``cli.train --moe_experts 4`` (``--fast``: depth 2, block 1 sparse),
    then ``cli.evaluate`` and ``load_engine``, which rebuild the MoE model
    from the sidecar's config: the engine serves the evaluated weights'
    outputs."""
    from rovit_kan_tpu_torch.cli import evaluate as cli_evaluate
    from rovit_kan_tpu_torch.cli import train as cli_train
    from rovit_kan_tpu_torch.evaluation.evaluator import \
        load_model_for_evaluation
    from rovit_kan_tpu_torch.models.rovit_kan import predict
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.utils.checkpoint import load_meta

    data, out = tmp_path / "data", tmp_path / "out"
    metrics = cli_train.main(["--data_root", str(data), "--output_dir",
                              str(out), "--synthetic", "--fast", "--cpu",
                              "--epochs", "1", "--moe_experts", "4"])
    assert np.isfinite(metrics["accuracy"])
    best = out / "checkpoints" / "best_model"
    assert load_meta(best)["config"]["model"]["moe_experts"] == 4
    ev = cli_evaluate.main(["--checkpoint", str(best), "--data_root",
                            str(data), "--output_dir", str(tmp_path / "ev"),
                            "--batch_size", "5", "--cpu"])
    assert ev is not None
    model, state = load_model_for_evaluation(best, device="cpu")
    blocks = model.backbone.model.blocks
    assert [hasattr(b, "moe") for b in blocks] == [False, True]
    assert state["backbone.model.blocks.1.moe.w1"].shape == (4, 32, 128)
    images = np.random.RandomState(0).randint(
        0, 256, (3, 64, 64, 3)).astype(np.uint8)
    served = load_engine(best, batch_size=4, device="cpu").predict(images)
    from rovit_kan_tpu_torch.ops.preprocess import eval_batch
    want = predict(model, eval_batch(torch.from_numpy(images)))
    np.testing.assert_allclose(served["cls_probs"],
                               want["cls_probs"].numpy(), rtol=0, atol=1e-6)
