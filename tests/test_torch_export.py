"""The port's export (``rovit_kan_tpu_torch/export.py``) and its custom ops.

The plain path's artifact is held against the JAX package's
``build_serving_forward`` on the same weights (fp32, 2e-5, T = 1.7, a
partial batch padded by the caller), and against the live port forward bit
for bit through ``save_exported``/``load_exported``; another batch size
fails the shape guard and ``platforms`` is refused. The custom ops: a graph
exported from a module that calls the three wrappers on fake CUDA tensors
under ``FakeTensorMode`` holds one node per call and loads in a subprocess
that imports only torch and the port's ops modules (and not without them);
each op's fake gives its plain version's shape and dtype; no op has a CPU
kernel.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
from rovit_kan_tpu.serving import build_serving_forward as jax_forward
from rovit_kan_tpu_torch.export import (
    export_serving,
    load_exported,
    load_serving,
    save_exported,
)
from rovit_kan_tpu_torch.models.convert import load_jax_params
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.ops import attention as at
from rovit_kan_tpu_torch.ops import block_kernel as bk
from rovit_kan_tpu_torch.ops import kan_kernel as kk
from rovit_kan_tpu_torch.ops.spline import make_knots
from rovit_kan_tpu_torch.serving import InferenceEngine, build_serving_forward

ROOT = Path(__file__).resolve().parent.parent
KW = dict(embed_dim=32, depth=1, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
TEMPERATURE = 1.7
BATCH = 8


def _imgs(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3)) \
        .astype(np.uint8)


@pytest.fixture(scope="module")
def pair():
    jm = JaxRoViTKAN(**KW)
    params = jm.init(jax.random.PRNGKey(5),
                     np.zeros((1, 32, 32, 3), np.float32))["params"]
    rng = np.random.RandomState(5)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), params)
    model = load_jax_params(RoViTKAN(**KW), params, device="cpu").eval()
    blob = export_serving(model, batch_size=BATCH, temperature=TEMPERATURE)
    return jm, params, model, blob


def test_artifact_matches_jax_serving(pair):
    jm, params, _, blob = pair
    imgs = _imgs(5)                           # partial: the caller pads
    padded = np.zeros((BATCH, 32, 32, 3), np.uint8)
    padded[:5] = imgs
    got = load_serving(blob)(padded)
    want = jax_forward(jm, temperature=TEMPERATURE)(params,
                                                    jnp.asarray(imgs))
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].numpy()[:5]
        assert g.shape == v.shape and g.dtype == v.dtype, k
        np.testing.assert_allclose(g, v, atol=2e-5, rtol=0, err_msg=k)


def test_artifact_round_trip_bits(pair, tmp_path):
    _, _, model, _ = pair
    path = tmp_path / "serving.pt2"
    n = save_exported(path, model, batch_size=BATCH,
                      temperature=TEMPERATURE)
    assert n == path.stat().st_size
    imgs = _imgs(BATCH, seed=1)
    got = load_exported(path)(imgs)
    with torch.inference_mode():
        want = build_serving_forward(model, TEMPERATURE)(
            torch.from_numpy(imgs))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # The fixed shape is part of the contract.
    with pytest.raises(RuntimeError, match="shape"):
        load_exported(path)(imgs[:5])


def test_platforms_refused(pair, tmp_path):
    _, _, model, _ = pair
    with pytest.raises(ValueError, match="device"):
        export_serving(model, batch_size=BATCH, platforms=("cpu",))
    with pytest.raises(ValueError, match="device"):
        save_exported(tmp_path / "x.pt2", model, platforms=["tpu"])
    assert not (tmp_path / "x.pt2").exists()


MOE_KW = dict(KW, depth=2, moe_experts=4)


@pytest.fixture(scope="module", params=[2, 1], ids=["every2", "every1"])
def moe_pair(request):
    """A MoE model (4 experts on block 1, or on both blocks) from perturbed
    JAX initial weights, and its artifact."""
    kw = dict(MOE_KW, moe_every=request.param)
    jm = JaxRoViTKAN(**kw)
    params = jm.init(jax.random.PRNGKey(6),
                     np.zeros((1, 32, 32, 3), np.float32))["params"]
    rng = np.random.RandomState(6)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), params)
    model = load_jax_params(RoViTKAN(**kw), params, device="cpu").eval()
    assert [hasattr(b, "moe") for b in model.backbone.model.blocks] == (
        [False, True] if request.param == 2 else [True, True])
    blob = export_serving(model, batch_size=BATCH, temperature=TEMPERATURE)
    return jm, params, model, blob


def test_moe_artifact_matches_engine_and_jax(moe_pair):
    """The artifact's outputs: the eager MoE engine's bits on a full batch,
    and the JAX serving forward's within 2e-5 on a padded partial one."""
    jm, params, model, blob = moe_pair
    serve = load_serving(blob)
    assert sum("sort" in str(n.target)
               for n in serve.program.graph.nodes) == sum(
        hasattr(b, "moe") for b in model.backbone.model.blocks)
    imgs = _imgs(BATCH, seed=2)
    want = InferenceEngine(model, batch_size=BATCH, temperature=TEMPERATURE,
                           device="cpu").predict(imgs)
    got = serve(imgs)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    padded = np.zeros((BATCH, 32, 32, 3), np.uint8)
    padded[:5] = imgs[:5]
    got = serve(padded)
    want = jax_forward(jm, temperature=TEMPERATURE)(params,
                                                    jnp.asarray(imgs[:5]))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy()[:5], np.asarray(v),
                                   atol=2e-5, rtol=0, err_msg=k)


# Shapes of the fake-CUDA graph: a block at D = 64 (2 heads of 32, hidden
# 256), attention at (2, 2, 9, 32), the KAN head [16, 8, 1] at B = 3.
D, HID, HEADS = 64, 256, 2
KAN_DIMS = (16, 8, 1)
KNOTS = make_knots()


def _fake_inputs(dtype):
    """Fake CUDA inputs of the three ops (made inside a FakeTensorMode)."""
    def t(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device="cuda")
    x = t(2, 9, D, dt=dtype)
    block = [t(*s, dt=dtype if k in bk.WEIGHT_KEYS else torch.float32)
             for k, s in bk.param_shapes(D, HID).items()]
    qkv = [t(2, HEADS, 9, D // HEADS, dt=dtype) for _ in range(3)]
    nb = len(KNOTS) - 4
    kan = []
    for a, b in zip(KAN_DIMS[:-1], KAN_DIMS[1:]):
        kan += [t(a, b, nb), t(b, a), t(b)]
    return x, block, qkv, t(3, KAN_DIMS[0]), kan


class _WrapperCalls(torch.nn.Module):
    """Two block calls, one attention call, one KAN head call."""

    def forward(self, x, q, k, v, kx, *tensors):
        params = dict(zip(bk.PKEYS, tensors[:12]))
        y = bk.fused_vit_block(x, params, HEADS)
        y = bk.fused_vit_block(y, params, HEADS)
        return (y, at.fused_attention(q, k, v),
                kk.fused_kan_module(kx, list(tensors[12:]), KNOTS))


LOAD = """
import json, sys, torch
{imports}
program = torch.export.load(sys.argv[1])
counts = {{}}
for n in program.graph.nodes:
    if n.op == "call_function":
        counts[str(n.target)] = counts.get(str(n.target), 0) + 1
mods = sorted(m for m in sys.modules if m.startswith("rovit_kan_tpu"))
print(json.dumps({{"counts": counts, "modules": mods}}))
"""
OPS_IMPORTS = ("import rovit_kan_tpu_torch.ops.block_kernel\n"
               "import rovit_kan_tpu_torch.ops.attention\n"
               "import rovit_kan_tpu_torch.ops.kan_kernel")


def _load_in_subprocess(path, imports):
    return subprocess.run(
        [sys.executable, "-c", LOAD.format(imports=imports), str(path)],
        capture_output=True, text=True, timeout=240, cwd=ROOT)


def test_custom_op_graph_from_fake_cuda_tensors(tmp_path):
    with FakeTensorMode():
        x, block, (q, k, v), kx, kan = _fake_inputs(torch.bfloat16)
        program = torch.export.export(_WrapperCalls(),
                                      (x, q, k, v, kx, *block, *kan),
                                      strict=False)
    calls = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    assert calls == ["rovit_kan_torch.vit_block_fwd.default"] * 2 + [
        "rovit_kan_torch.attention_fwd.default",
        "rovit_kan_torch.kan_module_fwd.default"]
    program.example_inputs = None
    path = tmp_path / "ops.pt2"
    torch.export.save(program, path)

    run = _load_in_subprocess(path, OPS_IMPORTS)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["counts"] == {"rovit_kan_torch.vit_block_fwd.default": 2,
                             "rovit_kan_torch.attention_fwd.default": 1,
                             "rovit_kan_torch.kan_module_fwd.default": 1}
    # torch and the op library: no model code, config or serving module.
    assert "rovit_kan_tpu_torch.ops.block_kernel" in got["modules"]
    assert all(m == "rovit_kan_tpu_torch"
               or m.startswith("rovit_kan_tpu_torch.ops")
               for m in got["modules"]), got["modules"]
    # Without the op library the graph cannot be loaded.
    bare = _load_in_subprocess(path, "")
    assert bare.returncode != 0
    assert "rovit_kan_torch" in bare.stderr


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_op_fakes_give_the_plain_shapes(dtype):
    rng = np.random.RandomState(7)
    with FakeTensorMode():
        x, block, (q, k, v), kx, kan = _fake_inputs(dtype)
        fakes = {"vit_block_fwd": bk._VIT_BLOCK_FWD(x, block, HEADS),
                 "attention_fwd": at._ATTENTION_FWD(q, k, v),
                 "kan_module_fwd": kk._KAN_MODULE_FWD(
                     kx, kan, [float(t) for t in KNOTS], 3)}

    def real(t):
        return torch.tensor(rng.normal(0, 0.1, tuple(t.shape)),
                            dtype=t.dtype)

    params = {key: real(t) for key, t in zip(bk.PKEYS, block)}
    plain = {"vit_block_fwd": bk.block_reference(real(x), params, HEADS),
             "attention_fwd": at.attention_reference(real(q), real(k),
                                                     real(v)),
             "kan_module_fwd": kk.kan_module_reference(
                 real(kx), [real(t) for t in kan], KNOTS, 3)}
    for name, want in plain.items():
        got = fakes[name]
        assert got.device.type == "cuda", name
        assert (tuple(got.shape), got.dtype) == (tuple(want.shape),
                                                 want.dtype), name


def test_ops_have_no_cpu_kernel():
    x = torch.zeros(1, 4, D, dtype=torch.bfloat16)
    params = bk.prepare_block_params(
        {k: torch.zeros(s) for k, s in bk.param_shapes(D, HID).items()},
        torch.bfloat16)
    with pytest.raises(NotImplementedError):
        bk._VIT_BLOCK_FWD(x, [params[k] for k in bk.PKEYS], HEADS)
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(NotImplementedError):
        at._ATTENTION_FWD(q, q, q)
    # The wrappers take the plain versions on the CPU, never the op.
    out = bk.fused_vit_block(x, params, HEADS)
    assert torch.equal(out, bk.block_reference(x, params, HEADS))
