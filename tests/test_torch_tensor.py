"""Tensor and sequence parallelism (``parallel/tensor.py``) against one
process and the JAX ``Trainer`` on a 2-D mesh.

- the rules: the port's Megatron specs and its FSDP+TP specs against the
  JAX ``param_specs`` and ``fsdp_param_specs(tp=True)`` on the flagship's
  and the base preset's 224-px trees, leaf for leaf; the per-rank bytes
  against the JAX ``sharded_size`` (12,176,488, 175,988,584 and 6,139,112
  B); the iota test: each rank's shards of a tree whose every element is its
  flat index against the JAX ``shard_params``' addressable shards, bit for
  bit; the per-axis fallback; the mesh's errors;
- one four-rank gloo launch, data 2 x model 2 (``python
  tests/test_torch_tensor.py TASK``, started as ``tests/test_torch_fsdp.py``
  starts its ranks), that runs every multi-rank case, for the JAX tests'
  toy (d = 32, 2 heads, 5 tokens, so sequence parallelism pads one filler
  token) and a 3-head toy at d = 48 (t = 2 does not divide the heads):
  TP, TP + SP, FSDP + TP and MoE + SP steps with dropout and CutMix/MixUp
  against one process (loss 1e-5 relative, parameters and EMA 2e-6, the
  bounds of ``tests/test_parallel.py``), the same four with the JAX draws
  against the JAX ``Trainer`` with ``param_specs`` (and ``seq_sharding``)
  on ``make_2d_mesh(2, 2)``, which the ranks also run (losses 1e-4,
  parameters 2e-5); the SP forward against the unsharded one (1e-5) and SP
  with remat (the same gradients); the replicated leaves' gradients on the
  model ranks (equal bit for bit under TP, partial under SP); each rank's
  state bytes; a TP + SP fit whose checkpoint is the single-card file, a
  one-process checkpoint resumed under TP + SP, and a fit over the sharded
  ``DeviceLoader``; the explainability taps under TP and TP + SP (both
  toys at depth 2, perturbed weights): every head's attention maps, the
  norm1 tap and its Grad-CAM gradient against one process and the JAX
  model's taps (2e-5, and 1e-4 of the gradient's largest, the bounds of
  ``tests/test_torch_explainability.py``), and ``ViTAttentionRollout`` and
  ``GradCAMPlusPlus`` run on the ``TensorParallel`` model;
- ``cli.train --cpu --devices 2 --tensor_parallel 2 --sequence_parallel``,
  started beside the launch, and the JAX script's flag rules read by
  ``ast``.
"""
from __future__ import annotations

import ast
import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.convert import _jax_path
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.parallel.fsdp import (
    FSDP,
    fsdp_param_specs,
    sharded_size,
)
from rovit_kan_tpu_torch.parallel.mesh import Mesh
from rovit_kan_tpu_torch.parallel.tensor import (
    TensorParallel,
    jax_spec,
    mesh_specs,
    param_specs,
    seq_sharding,
    shard_params,
)
from rovit_kan_tpu_torch.training import optimizer as topt
from rovit_kan_tpu_torch.training.trainer import make_train_step

ROOT = Path(__file__).resolve().parent.parent
JAX_TRAIN = ROOT / "scripts" / "train.py"
TOYS = {
    "h2": dict(embed_dim=32, depth=1, num_heads=2, image_size=32,
               patch_size=16, kan_layers=(32, 8, 1), hidden_dim=16),
    "h3": dict(embed_dim=48, depth=1, num_heads=3, image_size=32,
               patch_size=16, kan_layers=(48, 8, 1), hidden_dim=16)}
MODES = ("tp", "sp", "fsdp_tp", "moe_sp")
# Stage 4 first: every head's first update is from the common weights.
# (Where a head first moves after the trunk's forward has parted by
# rounding, an element whose gradient sits at ~1e-7 of its leaf's largest
# becomes an Adam step near eps: with stages 2, 4, 4 one element of the
# uncertainty head parted by 6e-6, MoE + SP, d = 32.)
STAGES = [(4, 1.0), (2, 0.0), (4, 1.0)]
ALPHA = np.asarray([1.1, 0.9, 1.0, 1.2], np.float32)
LR = 5e-4
MIN_SIZE = 256          # the JAX FSDP test's, so the toys shard leaves
TIMEOUT = 240
DATA, MODEL = 2, 2
FLAGSHIP_TP_BYTES = 12_176_488
BASE_TP_BYTES = 175_988_584
FLAGSHIP_FSDP_TP_BYTES = 6_139_112


def layout_mesh(data: int, model: int, d: int = 0, m: int = 0) -> Mesh:
    """Rank (d, m)'s view of a data x model mesh, without a process group
    (enough for the layouts, which run no collective)."""
    return Mesh(data, d, torch.device("cpu"), "gloo", second_size=model,
                second_rank=m, axis_names=("data", "model"))


def model_kw(toy: str, mode: str, dropout: float) -> dict:
    kw = dict(TOYS[toy], dropout=dropout)
    if mode == "moe_sp":
        kw.update(depth=2, moe_experts=4)
    return kw


# -- the rules ----------------------------------------------------------------

def _jax_shapes(preset: str):
    import jax

    from rovit_kan_tpu.config import get_config as jax_get_config
    from rovit_kan_tpu.models.rovit_kan import build_model as jax_build
    return jax.eval_shape(jax_build(jax_get_config(preset)).init,
                          jax.random.PRNGKey(0),
                          np.zeros((1, 224, 224, 3), np.float32))["params"]


def _meta_model(preset: str) -> RoViTKAN:
    from rovit_kan_tpu_torch.config import get_config
    m = get_config(preset).model
    with torch.device("meta"):
        return RoViTKAN(embed_dim=m.embed_dim, depth=m.depth,
                        num_heads=m.num_heads, mlp_ratio=m.mlp_ratio,
                        hidden_dim=m.hidden_dim,
                        kan_layers=tuple(m.kan_layers))


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _trim(spec) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _jax_layout(ndim: int, transpose: bool, **dims) -> tuple:
    """A JAX spec tuple (trailing Nones dropped) from port dims per axis."""
    spec = [None] * ndim
    for axis, d in dims.items():
        if d is not None:
            spec[ndim - 1 - d if transpose else d] = axis
    return _trim(spec)


@pytest.mark.parametrize("preset", ["tiny", "base"])
def test_specs_match_jax(preset):
    """``param_specs`` and ``fsdp_param_specs(tp=True)`` against JAX's on
    the 224-px tree, leaf for leaf (72 of 173 leaves TP-sharded)."""
    from rovit_kan_tpu.parallel.fsdp import fsdp_param_specs as jax_fsdp
    from rovit_kan_tpu.parallel.tensor import make_2d_mesh as jax_2d
    from rovit_kan_tpu.parallel.tensor import param_specs as jax_specs
    shapes = _jax_shapes(preset)
    jtp = jax_specs(shapes)
    jmesh = jax_2d(DATA, MODEL)
    jboth = jax_fsdp(shapes, jmesh, tp=True)
    model = _meta_model(preset)
    mesh = layout_mesh(DATA, MODEL)
    tp = param_specs(model)
    both = fsdp_param_specs(model, mesh, tp=True)
    assert len(tp) == 173 and sum(d is not None for d in tp.values()) == 72
    for name, p in model.named_parameters():
        path, transpose = _jax_path(name, p.dim())
        want = tuple(_leaf(jtp, path))
        assert want == jax_spec(name, p.dim()), name
        assert _trim(want) == _jax_layout(p.dim(), transpose,
                                          model=tp[name]), name
        assert tuple(_leaf(jboth, path)) == _jax_layout(
            p.dim(), transpose, model=tp[name], data=both[name]), name


def test_bytes_match_jax():
    """Per-rank parameter bytes: the flagship and the base preset under
    TP = 2, the flagship under FSDP + TP on data 2 x model 2."""
    from jax.sharding import PartitionSpec as P

    import jax
    from rovit_kan_tpu.parallel.fsdp import fsdp_param_specs as jax_fsdp
    from rovit_kan_tpu.parallel.fsdp import sharded_size as jax_size
    from rovit_kan_tpu.parallel.tensor import make_2d_mesh as jax_2d
    from rovit_kan_tpu.parallel.tensor import param_specs as jax_specs
    jtp_mesh, jmesh = jax_2d(1, MODEL), jax_2d(DATA, MODEL)
    tp_mesh, mesh = layout_mesh(1, MODEL), layout_mesh(DATA, MODEL)
    got = {}
    for preset in ("tiny", "base"):
        shapes, model = _jax_shapes(preset), _meta_model(preset)
        replicated = jax_size(shapes, jax.tree.map(lambda _: P(), shapes),
                              jtp_mesh)
        assert sharded_size(model, {}, tp_mesh) == replicated
        got[preset] = sharded_size(model, {}, tp_mesh, param_specs(model))
        assert got[preset] == jax_size(shapes, jax_specs(shapes), jtp_mesh)
        if preset == "tiny":
            both = sharded_size(model, fsdp_param_specs(model, mesh, tp=True),
                                mesh, param_specs(model))
            assert both == jax_size(shapes, jax_fsdp(shapes, jmesh, tp=True),
                                    jmesh) == FLAGSHIP_FSDP_TP_BYTES
    assert got == {"tiny": FLAGSHIP_TP_BYTES, "base": BASE_TP_BYTES}


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp_tp"])
def test_iota_shards_are_jax_addressable_shards(fsdp):
    """Every element of the flagship's tree is its flat index; rank (d, m)
    holds exactly what the JAX ``shard_params`` puts on device d * 2 + m
    of ``make_2d_mesh(2, 2)``, transposed to the port's layout."""
    import jax

    from rovit_kan_tpu.parallel.fsdp import fsdp_param_specs as jax_fsdp
    from rovit_kan_tpu.parallel.tensor import make_2d_mesh as jax_2d
    from rovit_kan_tpu.parallel.tensor import param_specs as jax_specs
    from rovit_kan_tpu.parallel.tensor import shard_params as jax_shard
    from rovit_kan_tpu_torch.models.convert import load_jax_params
    shapes = _jax_shapes("tiny")
    jmesh = jax_2d(DATA, MODEL)
    jspecs = (jax_fsdp(shapes, jmesh, tp=True) if fsdp
              else jax_specs(shapes))
    iota = jax.tree.map(
        lambda s: np.arange(int(np.prod(s.shape)),
                            dtype=np.float32).reshape(s.shape), shapes)
    placed = jax_shard(iota, jmesh, jspecs)
    model = load_jax_params(RoViTKAN(), iota, device="cpu")
    ranks = []
    for r in range(DATA * MODEL):
        mesh = layout_mesh(DATA, MODEL, r // MODEL, r % MODEL)
        m = copy.deepcopy(model)
        tp = TensorParallel(m, mesh)
        net = FSDP(m, mesh, fsdp_param_specs(tp, mesh, tp=True),
                   tp=tp) if fsdp else tp
        ranks.append(net.state_dict())
    for name, p in model.named_parameters():
        path, transpose = _jax_path(name, p.dim())
        shards = sorted(_leaf(placed, path).addressable_shards,
                        key=lambda s: s.device.id)
        for r in range(DATA * MODEL):
            got = ranks[r][name].numpy()
            np.testing.assert_array_equal(got.T if transpose else got,
                                          np.asarray(shards[r].data),
                                          err_msg=f"{name} rank {r}")


def test_shard_params_falls_back_per_axis():
    """The JAX test's cases: a dim the model axis does not divide is
    replicated, the others keep their sharding; ``shard_params`` cuts the
    rest contiguously."""
    mesh = layout_mesh(2, 4, 0, 1)
    shapes = {"a": (6, 4), "b": (4, 8), "c": (12, 6)}
    assert mesh_specs(shapes, {"a": 0, "b": 1, "c": 0}, mesh) == \
        {"a": None, "b": 1, "c": 0}
    state = {"backbone.model.blocks.0.attn.qkv.weight":
             torch.arange(96 * 32.).reshape(96, 32)}
    part = shard_params(state, mesh)
    assert torch.equal(part["backbone.model.blocks.0.attn.qkv.weight"],
                       state["backbone.model.blocks.0.attn.qkv.weight"]
                       [24:48])
    with pytest.raises(ValueError, match="do not divide"):
        TensorParallel(RoViTKAN(**TOYS["h3"]), layout_mesh(1, 5))


def test_shard_state_cuts_params_moments_and_ema():
    """``shard_state`` of a one-process ``TrainState`` (after one flat
    AdamW step, the EMA on): each rank's parameters, EMA and moments are
    its shards, and the two ranks' shards put back along the specs' dims
    give the whole leaves and moments."""
    from rovit_kan_tpu_torch.parallel.tensor import shard_state
    from rovit_kan_tpu_torch.training.trainer import TrainState
    model = RoViTKAN(**TOYS["h3"])
    opt = topt.build_optimizer(model, _config())
    opt.grad.normal_(generator=torch.Generator().manual_seed(0))
    opt.step()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ema = {k: v + 1.0 for k, v in params.items()}
    state = TrainState(params, opt.state_dict(), ema, step=1)
    parts = []
    for m in range(MODEL):
        tp = TensorParallel(copy.deepcopy(model), layout_mesh(1, MODEL, 0, m))
        cut = shard_state(state, tp)
        assert cut.step == 1 and cut.opt_state["names"] == [
            k for k, _ in tp.named_parameters()]
        parts.append((tp, cut))
    tp = parts[0][0]
    for key in ("mu", "nu"):
        whole = dict(zip(opt.names, torch.split(state.opt_state[key],
                                                opt._sizes)))
        got = [dict(zip(cut.opt_state["names"], torch.split(
            cut.opt_state[key], [t.numel() for t in tp.local(
                {k: whole[k].view(tp.full_shapes[k])
                 for k in cut.opt_state["names"]}).values()])))
            for _, cut in parts]
        for k, v in whole.items():
            d = tp.specs[k]
            v = v.view(tp.full_shapes[k])
            back = (torch.cat([g[k].view(-1, *v.shape[1:]) if d == 0 else
                               g[k].view(*v.shape[:-1], -1) for g in got],
                              d) if d is not None else got[0][k].view_as(v))
            assert torch.equal(back, v), (key, k)
    for name in ("params", "ema_params"):
        want = getattr(state, name)
        for k, v in want.items():
            d = tp.specs[k]
            pieces = [getattr(cut, name)[k] for _, cut in parts]
            back = torch.cat(pieces, d) if d is not None else pieces[0]
            assert torch.equal(back, v), (name, k)


def test_make_2d_mesh_errors_as_jax():
    from rovit_kan_tpu_torch.parallel.mesh import make_2d_mesh
    with pytest.raises(ValueError, match="at least model = 16 devices"):
        make_2d_mesh(data=-1, model=16, device="cpu")
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_2d_mesh(2, 2, device="cpu")
    one = make_2d_mesh(1, 1, device="cpu")
    assert one.axis_names == ("data", "model") and one.world == 1
    with pytest.raises(ValueError, match="'model' axis"):
        TensorParallel(RoViTKAN(**TOYS["h2"]),
                       Mesh(2, 0, torch.device("cpu"), "gloo"))


def test_forced_block_kernel_refuses_sharding():
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    cfg = Config()
    cfg.tpu.use_pallas_block = True
    with pytest.raises(ValueError, match="whole-block kernels"):
        build_model(cfg, device="cpu",
                    act_sharding=seq_sharding(layout_mesh(1, 2)))


# -- the ranks ----------------------------------------------------------------

def _config(**train) -> Config:
    cfg = Config()
    cfg.flags.mixed_precision = False
    cfg.data.image_size = 32
    cfg.train.learning_rate = LR
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def build_net(model, mesh, mode: str, remat: bool = False):
    """``model`` on ``mesh`` as ``mode`` runs it (itself on None)."""
    vit = model.backbone.model
    vit.remat = remat
    if mesh is None:
        return model
    if mode in ("sp", "moe_sp"):
        vit.act_sharding = seq_sharding(mesh)
    tp = TensorParallel(model, mesh)
    if mode == "fsdp_tp":
        return FSDP(model, mesh, fsdp_param_specs(tp, mesh, min_size=MIN_SIZE,
                                                  tp=True), tp=tp)
    return tp


def _batch(step: int, b: int = 8):
    rng = np.random.RandomState(100 + step)
    images = rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, b)
    return {"images": torch.from_numpy(images),
            "labels": torch.from_numpy(labels).long(),
            "severity": torch.from_numpy(labels.astype(np.float32))}


def run_steps(case: dict, mesh) -> dict:
    """``case``'s steps from its weights, on ``mesh`` as ``case["mode"]``
    (None: one process)."""
    cfg = _config(fused_augment=case["fused_augment"],
                  ema_decay=case.get("ema_decay", 0.0))
    model = RoViTKAN(**case["model_kw"])
    model.load_state_dict(case["state_dict"])
    net = build_net(model, mesh, case["mode"])
    opt = topt.build_optimizer(net, cfg)
    step = make_train_step(net, opt, cfg, focal_alpha=ALPHA,
                           generator=torch.Generator().manual_seed(3),
                           mesh=mesh)
    out = {"losses": []}
    for i, (stage, live) in enumerate(STAGES):
        topt.set_hyperparams(opt, LR, 0.1 * live)
        draws = case["draws"][i] if case["draws"] else None
        m = step(case["batches"][i], stage, live, 1, draws=draws)
        out["losses"].append(float(m["total_loss"]))
    if mesh is None:
        out["params"] = {k: v.clone() for k, v in model.state_dict().items()}
        out["ema"] = step.ema
        return out
    out["params"] = net.gather_full(net.state_dict())
    out["ema"] = net.gather_full(step.ema) if step.ema else None
    whole = set(net.model_sharded) | set(getattr(net, "shards", ()))
    out["replicated"] = {k: v.clone() for k, v in net.state_dict().items()
                         if k not in whole}
    out["bytes"] = {
        "params": sum(v.numel() * 4 for v in net.state_dict().values()),
        "mu": opt.mu.numel() * 4, "nu": opt.nu.numel() * 4,
        "ema": (sum(v.numel() * 4 for v in step.ema.values())
                if step.ema else None)}
    tp = net.tp if isinstance(net, FSDP) else net
    out["sharded_size"] = sharded_size(
        tp, net.specs if isinstance(net, FSDP) else {}, mesh, tp.specs)
    return out


def forward_grads(case: dict, mesh) -> dict:
    """One deterministic forward and backward of ``case``'s model on
    ``mesh``: the outputs, each replicated leaf's gradient as this rank
    holds it (before any sum), and the whole gradient (summed over
    "model" where partial, gathered over it where sharded)."""
    model = RoViTKAN(**case["model_kw"])
    model.load_state_dict(case["state_dict"])
    net = build_net(model, mesh, case["mode"], remat=case.get("remat", False))
    net.eval()
    x = torch.from_numpy(case["x"])
    out = net(x)
    (out["cls_logits"] ** 2).sum().backward()
    res = {"cls_logits": out["cls_logits"].detach().clone()}

    def grad(p):          # the heads cls_logits does not read have none
        return torch.zeros_like(p) if p.grad is None else p.grad.clone()
    if mesh is None:
        res["grads"] = {k: grad(p) for k, p in model.named_parameters()}
        return res
    grads = {k: grad(p) for k, p in net.named_parameters()}
    res["rank_grads"] = {k: g.clone() for k, g in grads.items()
                         if k not in net.model_sharded}
    for k in sorted(net.partial):      # one order on every rank
        mesh.all_reduce_(grads[k], "model")
    res["grads"] = net.gather_full(grads)
    return res


def run_taps(case: dict, mesh) -> dict:
    """The explainability taps of ``case``'s model on ``mesh`` (eval): the
    attention maps, the norm1 tap and its gradient for the predicted
    classes, and the rollout and Grad-CAM++ maps of the classes that wrap
    the model."""
    from rovit_kan_tpu_torch.explainability.attention_maps import \
        ViTAttentionRollout
    from rovit_kan_tpu_torch.explainability.gradcam import (
        GradCAMPlusPlus,
        gradcam_taps,
    )
    model = RoViTKAN(**case["model_kw"])
    model.load_state_dict(case["state_dict"])
    net = build_net(model, mesh, case["mode"]).eval()
    x = torch.from_numpy(case["x"])
    with torch.no_grad():
        attention = net(x, return_attention=True)["attention"]
    tap, grad, idx = gradcam_taps(net, x, torch.full((len(x),), -1))
    return {"attention": attention, "tap": tap, "grad": grad, "idx": idx,
            "rollout": ViTAttentionRollout(net, device="cpu").maps(x),
            "gradcam": GradCAMPlusPlus(net, device="cpu").maps(x)}


def run_fit(case: dict, mesh) -> dict:
    """A 2-epoch ``Trainer.fit`` of the toy (TP + SP on a mesh), its last
    state saved as ``last`` and returned whole; on the mesh also a
    one-process checkpoint resumed, and with ``shard_data`` the sharded
    ``DeviceLoader``'s fit."""
    from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from test_torch_fsdp import _fit_config, _whole
    from test_torch_parallel import ArrayDS
    ckpt = Path(case["dir"]) / "checkpoints"
    cfg = _fit_config(ckpt)
    shard = case.get("shard_data", False)
    train = DeviceLoader(ArrayDS(40), 8, shuffle=True, drop_last=True,
                         seed=5, device="cpu", mesh=mesh, shard_data=shard)
    val = DeviceLoader(ArrayDS(13, seed=1), 8, device="cpu", mesh=mesh,
                       shard_data=shard)
    act = None if mesh is None else seq_sharding(mesh)
    tr = Trainer(build_model(cfg, device="cpu", seed=0, act_sharding=act),
                 train, val, cfg, focal_alpha=ALPHA, seed=0, mesh=mesh)
    fit = tr.fit()
    out = {"val_loss": [h["total_loss"] for h in fit["history"]["val"]],
           "train_loss": [h["total_loss"] for h in fit["history"]["train"]],
           "tp": tr.tp is not None}
    if shard:
        out["shard"] = train.arrays[0].clone()
        return out
    tr.save_checkpoint(fit["state"], 2, fit["history"]["val"][-1],
                       name="last")
    out["state"] = _whole(tr, fit["state"]) if mesh is None else \
        _sharded_whole(tr, fit["state"])
    if mesh is not None:
        tr.config.paths.checkpoints_dir = Path(case["resume"])
        state, epoch = tr.resume("last")
        out["resumed"] = _sharded_whole(tr, state)
        out["resumed_epoch"] = epoch
    return out


def _sharded_whole(trainer, state) -> dict:
    w = trainer.sharded
    opt = w.full_opt_state(state.opt_state)
    params, ema = w.gather_full(state.params), w.gather_full(state.ema_params)
    if opt is None:
        return None
    return {"params": params, "mu": opt["mu"], "nu": opt["nu"], "ema": ema}


def run_jax(case: dict) -> dict:
    """The JAX ``Trainer`` on ``make_2d_mesh(2, 2)`` with ``param_specs``
    (``fsdp_param_specs(tp=True)`` for FSDP + TP, ``seq_sharding`` for SP)
    from the port's start weights: its losses and final parameters."""
    import jax
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from rovit_kan_tpu.config import Config as JaxConfig
    from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
    from rovit_kan_tpu.parallel.fsdp import fsdp_param_specs as jax_fsdp
    from rovit_kan_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from rovit_kan_tpu.parallel.tensor import make_2d_mesh as jax_2d
    from rovit_kan_tpu.parallel.tensor import param_specs as jax_specs
    from rovit_kan_tpu.parallel.tensor import seq_sharding as jax_seq
    from rovit_kan_tpu.training.optimizer import \
        set_hyperparams as jax_set_hyperparams
    from rovit_kan_tpu.training.trainer import Trainer as JaxTrainer

    jcfg = JaxConfig()
    jcfg.flags.mixed_precision = False
    jcfg.data.image_size = 32
    jcfg.train.learning_rate = LR
    jmesh = jax_2d(DATA, MODEL)
    mode = case["mode"]
    jmodel = JaxRoViTKAN(**case["model_kw"], use_pallas_block=False,
                         use_pallas_kan=False, use_pallas_attention=False,
                         act_sharding=(jax_seq(jmesh) if "sp" in mode
                                       else None))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            np.zeros((1, 32, 32, 3), np.float32))["params"]
    specs = (jax_fsdp(shapes, jmesh, min_size=MIN_SIZE, tp=True)
             if mode == "fsdp_tp" else jax_specs(shapes))
    trainer = JaxTrainer(jmodel, None, None, jcfg, focal_alpha=ALPHA,
                         mesh=jmesh, seed=0, param_specs=specs)
    state = trainer.init_state(params=case["jax_params"])
    losses = []
    for i, (stage, live) in enumerate(STAGES):
        b = case["batches"][i]
        state = state.replace(opt_state=jax_set_hyperparams(
            state.opt_state, LR, 0.1 * live))
        jb = {"images": b["images"].numpy(),
              "labels": b["labels"].numpy().astype(np.int32),
              "severity": b["severity"].numpy()}
        state, m = trainer.train_step(state, jax_shard_batch(jb, jmesh),
                                      jnp.int32(stage), jnp.float32(live),
                                      jnp.float32(1.0))
        losses.append(float(m["total_loss"]))
    return {"losses": losses,
            "params": jax.tree.map(np.asarray, state.params)}


def _worker(task_path: str) -> None:
    from rovit_kan_tpu_torch.parallel.mesh import make_2d_mesh
    task = torch.load(task_path, weights_only=False)
    mesh = make_2d_mesh(DATA, MODEL, device="cpu")
    out = {}
    for name, case in task["ranks"].items():
        kind = case.get("kind", "steps")
        fn = {"steps": run_steps, "grads": forward_grads,
              "fit": run_fit, "taps": run_taps}[kind]
        out[name] = fn(case, mesh)
    # The JAX runs, spread over the ranks (they need no collective).
    for i, (name, case) in enumerate(task["jax"].items()):
        if i % mesh.world == mesh.global_rank:
            out[name] = run_jax(case)
    torch.save(out, Path(task_path).parent / f"out{mesh.global_rank}.pt")


# -- one launch, every case ---------------------------------------------------

def _start_ranks(task: dict, tmp: Path, n: int):
    from test_torch_parallel import start_ranks
    return start_ranks(__file__, task, tmp, n)


def _join(procs, tmp: Path) -> list:
    from test_torch_parallel import join_ranks
    return join_ranks(procs, tmp)


def _jax_draws(n: int, seed: int = 0) -> list:
    """The draws the JAX step takes from ``init_state(params=...)``'s key
    chain: each step splits its key into the next key, the augment's and
    the mix's."""
    import jax

    from rovit_kan_tpu.ops.augment_kernel import _draw_factors
    from test_torch_mixing import jax_draws
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, k_aug, k_mix, _ = jax.random.split(rng, 4)
        out.append({"factors": torch.from_numpy(np.array(
            _draw_factors(k_aug, 8, 0.2, 0.2, 0.2))),
            "mix": jax_draws(k_mix, 8, 32, 32), "dropout": None})
    return out


def _cli_train(tmp: Path):
    cmd = [sys.executable, "-m", "rovit_kan_tpu_torch.cli.train",
           "--data_root", str(tmp / "data"), "--synthetic", "--fast",
           "--cpu", "--output_dir", str(tmp / "out"), "--devices", "2",
           "--tensor_parallel", "2", "--sequence_parallel"]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The one launch of four ranks (and the JAX runs in them), the CLI run
    beside it, and the one-process runs meanwhile."""
    from rovit_kan_tpu_torch.models.convert import to_jax_params
    from test_torch_explainability import _jax_taps
    tmp = tmp_path_factory.mktemp("tensor")
    batches = [_batch(i) for i in range(len(STAGES))]
    jdraws = _jax_draws(len(STAGES))
    ranks_task, jax_task, single_task = {}, {}, {}
    starts = {}
    for toy in TOYS:
        for mode in MODES:
            torch.manual_seed(1)
            kw = model_kw(toy, mode, 0.3)
            sd = RoViTKAN(**kw).state_dict()
            starts[toy, mode] = sd
            ranks_task[f"{toy}_{mode}"] = single_task[f"{toy}_{mode}"] = {
                "model_kw": kw, "state_dict": sd, "mode": mode,
                "fused_augment": True, "ema_decay": 0.9, "draws": None,
                "batches": batches}
            kw0 = model_kw(toy, mode, 0.0)
            model0 = RoViTKAN(**kw0)
            model0.load_state_dict(sd)
            case = {"model_kw": kw0, "state_dict": sd, "mode": mode,
                    "fused_augment": "auto", "draws": jdraws,
                    "batches": batches}
            ranks_task[f"jaxdraws_{toy}_{mode}"] = case
            jax_task[f"jax_{toy}_{mode}"] = dict(
                case, jax_params=to_jax_params(model0))
    x = (np.random.RandomState(7).rand(8, 32, 32, 3).astype(np.float32)
         - 0.5)
    for mode in ("tp", "sp"):
        for remat in (False, True):
            ranks_task[f"grads_{mode}_{int(remat)}"] = {
                "kind": "grads", "model_kw": model_kw("h2", mode, 0.0),
                "state_dict": starts["h2", "tp"], "mode": mode, "x": x,
                "remat": remat}
        ranks_task[f"grads_h3_{mode}"] = {
            "kind": "grads", "model_kw": model_kw("h3", mode, 0.0),
            "state_dict": starts["h3", "tp"], "mode": mode, "x": x}
    tap_start, jax_tap_params = {}, {}
    for toy in TOYS:
        kw = dict(TOYS[toy], depth=2, dropout=0.0)
        torch.manual_seed(2)
        sd = RoViTKAN(**kw).state_dict()
        # Away from LayerNorm's identity init, where Grad-CAM++ on the
        # norm1 tap is rounding noise.
        rng = np.random.RandomState(8)
        sd = {k: v + torch.from_numpy(rng.normal(0, 0.05, tuple(v.shape))
                                      .astype(np.float32))
              for k, v in sd.items()}
        model0 = RoViTKAN(**kw)
        model0.load_state_dict(sd)
        jax_tap_params[toy] = to_jax_params(model0)
        tap_start[toy] = sd
        for mode in ("tp", "sp"):
            ranks_task[f"taps_{toy}_{mode}"] = {
                "kind": "taps", "model_kw": kw, "state_dict": sd,
                "mode": mode, "x": x}
    single_dir = tmp / "single"
    ranks_task["fit"] = {"kind": "fit", "dir": str(tmp / "ranks"),
                         "resume": str(single_dir / "checkpoints")}
    ranks_task["fit_sharded"] = {"kind": "fit", "dir": str(tmp / "shard"),
                                 "shard_data": True}
    # The ranks resume this fit's checkpoint: it is written first.
    single = {"fit": run_fit({"dir": str(single_dir)}, None)}
    procs = _start_ranks({"ranks": ranks_task, "jax": jax_task}, tmp,
                         DATA * MODEL)
    cli = _cli_train(tmp / "cli")
    try:
        single.update({k: run_steps(c, None)
                       for k, c in single_task.items()})
        for k, c in ranks_task.items():
            if k.startswith("jaxdraws_"):
                single[k] = run_steps(c, None)
        single["grads"] = forward_grads(ranks_task["grads_tp_0"], None)
        single["grads_h3"] = forward_grads(ranks_task["grads_h3_tp"], None)
        for toy in TOYS:
            single[f"taps_{toy}"] = run_taps(ranks_task[f"taps_{toy}_tp"],
                                             None)
            kw = dict(TOYS[toy], depth=2)
            single[f"jax_taps_{toy}"] = dict(zip(
                ("attention", "tap", "grad"),
                _jax_taps(jax_tap_params[toy], x, **kw)))
        ranks = _join(procs, tmp)
        cli_log = cli.communicate(timeout=TIMEOUT)[0]
    finally:
        for p in procs + [cli]:
            if p.poll() is None:
                p.kill()
                p.wait()
    jax_out = {k: v for r in ranks for k, v in r.items()
               if k.startswith("jax_")}
    return {"single": single, "ranks": ranks, "jax": jax_out, "tmp": tmp,
            "starts": starts, "cli": (cli.returncode, cli_log)}


def _close(got: dict, want: dict, atol: float) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol,
                                   err_msg=k)


CASES = [f"{t}_{m}" for t in TOYS for m in MODES]


@pytest.mark.parametrize("case", CASES)
def test_steps_equal_one_process(launched, case):
    """Dropout, CutMix/MixUp and the fused augment's plain version on;
    stage 2 frozen, then stage 4 live: every rank's losses, and rank 0's
    gathered parameters and EMA, against one process."""
    single = launched["single"][case]
    for got in launched["ranks"]:
        np.testing.assert_allclose(got[case]["losses"], single["losses"],
                                   rtol=1e-5)
    got = launched["ranks"][0][case]
    _close(got["params"], single["params"], 2e-6)
    _close(got["ema"], single["ema"], 2e-6)
    assert all(r[case]["params"] is None for r in launched["ranks"][1:])
    qkv = "backbone.model.blocks.0.attn.qkv.weight"
    assert not torch.equal(got["params"][qkv],
                           launched["starts"][tuple(case.split("_", 1))][qkv])


@pytest.mark.parametrize("case", CASES)
def test_steps_match_jax_trainer(launched, case):
    """The same steps with the JAX draws, dropout off, against the JAX
    ``Trainer`` on ``make_2d_mesh(2, 2)`` (and against one process)."""
    from rovit_kan_tpu_torch.models.convert import to_jax_params
    from test_torch_train_step import _flat
    want = launched["jax"][f"jax_{case}"]
    got = launched["ranks"][0][f"jaxdraws_{case}"]
    single = launched["single"][f"jaxdraws_{case}"]
    for r in launched["ranks"]:
        np.testing.assert_allclose(r[f"jaxdraws_{case}"]["losses"],
                                   want["losses"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-5)
    toy, mode = case.split("_", 1)
    model = RoViTKAN(**model_kw(toy, mode, 0.0))
    model.load_state_dict(got["params"])
    jparams = dict(_flat(want["params"]))
    for k, v in dict(_flat(to_jax_params(model))).items():
        np.testing.assert_allclose(v, jparams[k], atol=2e-5,
                                   err_msg="/".join(k))


def test_replicated_leaves_equal_on_every_rank(launched):
    """After the steps every rank holds the same replicated leaves, bit for
    bit (the leaves neither axis shards)."""
    for case in CASES:
        first = launched["ranks"][0][case]["replicated"]
        assert first
        for r in launched["ranks"][1:]:
            for k, v in r[case]["replicated"].items():
                assert torch.equal(v, first[k]), (case, k)


def test_state_bytes_are_sharded_size(launched):
    """Each rank's parameters, moments and EMA are ``sharded_size``'s
    bytes, below the replicated figure."""
    full = sum(v.numel() * 4 for v in RoViTKAN(**TOYS["h2"]).parameters())
    for r in launched["ranks"]:
        for case in ("h2_tp", "h2_fsdp_tp"):
            want = r[case]["sharded_size"]
            assert r[case]["bytes"] == {"params": want, "mu": want,
                                        "nu": want, "ema": want}
            assert want < full
        assert r["h2_fsdp_tp"]["sharded_size"] < r["h2_tp"]["sharded_size"]


def test_replicated_gradients_on_the_model_ranks(launched):
    """Under TP without SP the replicated leaves' gradients agree bit for
    bit on the two model ranks of a data index; under SP they are each
    rank's tokens' part and differ; the whole gradient (the partial leaves
    summed, the sharded ones gathered) is one process's, 1e-5 of each
    leaf's largest, for both toys."""
    ranks = launched["ranks"]
    for d in range(DATA):
        a, b = (ranks[d * MODEL + m]["grads_tp_0"]["rank_grads"]
                for m in range(MODEL))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
        a, b = (ranks[d * MODEL + m]["grads_sp_0"]["rank_grads"]
                for m in range(MODEL))
        assert not torch.equal(
            a["backbone.model.blocks.0.norm1.weight"],
            b["backbone.model.blocks.0.norm1.weight"])
    for case, one in (("grads_tp_0", "grads"), ("grads_sp_0", "grads"),
                      ("grads_h3_tp", "grads_h3"),
                      ("grads_h3_sp", "grads_h3")):
        want = launched["single"][one]["grads"]
        got = ranks[0][case]["grads"]
        assert got.keys() == want.keys()
        for k, v in want.items():      # 1e-5 of each leaf's largest
            np.testing.assert_allclose(
                got[k].numpy(), v.numpy(), rtol=0,
                atol=1e-5 * max(float(v.abs().max()), 1e-30), err_msg=k)


def test_sp_forward_matches_the_unsharded_forward(launched):
    """The sequence-parallel forward (5 tokens padded to 6) against the
    one-process forward on the same weights, 1e-5, as the JAX
    ``test_sp_eval_matches_no_sp``."""
    want = launched["single"]["grads"]["cls_logits"]
    for r in launched["ranks"]:
        for case in ("grads_tp_0", "grads_sp_0"):
            np.testing.assert_allclose(r[case]["cls_logits"].numpy(),
                                       want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("toy", list(TOYS))
@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_taps_under_tp_and_sp(launched, mode, toy):
    """The attention maps ``(depth, B, heads, 5, 5)``, the norm1 tap and
    its gradient on every rank against one process and the JAX model's
    taps (maps and tap 2e-5, the gradient 1e-4 of its largest magnitude);
    the predicted classes equal; the rollout and Grad-CAM++ classes give
    what their functions give on the rank's taps."""
    from rovit_kan_tpu_torch.explainability.attention_maps import \
        attention_rollout
    from rovit_kan_tpu_torch.explainability.gradcam import _cam_from_grads
    one = {k: v.numpy() for k, v in launched["single"][f"taps_{toy}"].items()}
    ref = launched["single"][f"jax_taps_{toy}"]
    heads = TOYS[toy]["num_heads"]
    assert one["attention"].shape == (2, 8, heads, 5, 5)
    np.testing.assert_allclose(one["attention"], ref["attention"],
                               atol=2e-5, rtol=0)
    for r in launched["ranks"]:
        got = r[f"taps_{toy}_{mode}"]
        assert torch.equal(got["idx"], torch.from_numpy(one["idx"]))
        for want in (one, ref):
            for k in ("attention", "tap"):
                np.testing.assert_allclose(got[k].numpy(), want[k],
                                           atol=2e-5, rtol=0, err_msg=k)
            np.testing.assert_allclose(
                got["grad"].numpy(), want["grad"], rtol=0,
                atol=1e-4 * float(np.abs(want["grad"]).max()))
        assert torch.equal(got["rollout"], attention_rollout(
            got["attention"], image_size=32, discard_ratio=0.9,
            apply_discard=False))
        assert torch.equal(got["gradcam"],
                           _cam_from_grads(got["tap"], got["grad"], 32))


def test_sp_with_remat_gives_the_same_gradients(launched):
    r0 = launched["ranks"][0]
    for mode in ("tp", "sp"):
        plain, remat = r0[f"grads_{mode}_0"], r0[f"grads_{mode}_1"]
        for k, v in plain["grads"].items():
            np.testing.assert_allclose(remat["grads"][k].numpy(), v.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)


def test_tp_sp_fit_and_checkpoints(launched):
    """A TP + SP fit against the one-process fit; its checkpoint, read in
    one process, holds the ranks' gathered state bit for bit, resumes in a
    one-process ``Trainer`` with the same bits and serves through
    ``load_engine``; a one-process checkpoint resumed under TP + SP gives
    back its own state."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
    from test_torch_fsdp import _fit_config
    from test_torch_parallel import ArrayDS
    single = launched["single"]["fit"]
    fits = [r["fit"] for r in launched["ranks"]]
    assert fits[0]["tp"] and all(f["val_loss"] == fits[0]["val_loss"]
                                 for f in fits)
    np.testing.assert_allclose(fits[0]["val_loss"], single["val_loss"],
                               rtol=1e-5)
    _close(fits[0]["state"]["params"], single["state"]["params"], 1e-5)
    tmp = launched["tmp"]
    last = tmp / "ranks" / "checkpoints" / "last"
    ck = load_checkpoint(last)
    state = fits[0]["state"]
    for k, v in state["params"].items():
        assert torch.equal(ck["params"][k], v), k
        assert torch.equal(ck["ema_params"][k], state["ema"][k]), k
    assert torch.equal(ck["opt_state"]["mu"], state["mu"])
    cfg = _fit_config(tmp / "ranks" / "checkpoints")
    one = Trainer(build_model(cfg, device="cpu", seed=3), None, None, cfg,
                  seed=0)
    resumed, epoch = one.resume("last")
    assert epoch == 3
    for k, v in state["params"].items():
        assert torch.equal(resumed.params[k], v), k
    assert torch.equal(resumed.opt_state["nu"], state["nu"])
    engine = load_engine(last, device="cpu")
    assert np.isfinite(engine.predict(ArrayDS(3).images)["cls_probs"]).all()
    ck = load_checkpoint(tmp / "single" / "checkpoints" / "last")
    res = fits[0]["resumed"]
    assert fits[0]["resumed_epoch"] == 3
    assert all(f["resumed"] is None for f in fits[1:])
    for k, v in ck["params"].items():
        assert torch.equal(res["params"][k], v), k
        assert torch.equal(res["ema"][k], ck["ema_params"][k]), k
    assert torch.equal(res["mu"], ck["opt_state"]["mu"])


def test_sharded_loader_splits_by_the_data_coordinate(launched):
    """Over the sharded ``DeviceLoader`` the two model ranks of a data
    index hold its shard, the data indices differ, and every rank logs the
    same epochs."""
    fits = [r["fit_sharded"] for r in launched["ranks"]]
    for d in range(DATA):
        assert torch.equal(fits[d * MODEL]["shard"],
                           fits[d * MODEL + 1]["shard"])
    assert not torch.equal(fits[0]["shard"], fits[MODEL]["shard"])
    for f in fits:
        assert f["val_loss"] == fits[0]["val_loss"]
        assert f["train_loss"] == fits[0]["train_loss"]
        assert np.isfinite(f["train_loss"]).all()


def test_cli_train_tensor_and_sequence_parallel(launched):
    """``cli.train --cpu --devices 2 --tensor_parallel 2
    --sequence_parallel`` (data 1 x model 2): the JAX script's mesh and SP
    lines, and a ``best_model`` that is the single-card file."""
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
    from test_torch_parallel import ArrayDS
    rc, log = launched["cli"]
    assert rc == 0, log[-4000:]
    assert "Mesh: data=1 x model=2 (tensor parallel)" in log
    assert "Sequence parallel: residual stream tokens sharded over " \
        "model=2" in log
    out = launched["tmp"] / "cli" / "out"
    best = out / "checkpoints" / "best_model"
    ck = load_checkpoint(best)
    full = RoViTKAN(embed_dim=32, depth=2, num_heads=2, image_size=64,
                    kan_layers=(32, 8, 1), hidden_dim=16).state_dict()
    assert {k: v.shape for k, v in ck["params"].items()} == \
        {k: v.shape for k, v in full.items()}
    assert ck["opt_state"]["mu"].numel() == sum(v.numel()
                                                for v in full.values())
    probs = load_engine(best, device="cpu").predict(
        ArrayDS(3, size=64).images)["cls_probs"]
    assert np.isfinite(probs).all()
    assert (out / "results" / "test_metrics.json").exists()


# -- the JAX script's flag rules ----------------------------------------------

def _jax_rules():
    """The JAX script's flag rules that run before any data loads (the
    ``if`` statements on the parallelism flags at the top of ``main``) and
    its ``--devices`` remainder error (``run_one``), as functions of
    ``args``."""
    tree = ast.parse(JAX_TRAIN.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = {"sequence_parallel", "expert_parallel", "fsdp", "moe_experts"}
    rules = [s for s in main.body if isinstance(s, ast.If) and {
        n.attr for n in ast.walk(s.test) if isinstance(n, ast.Attribute)}
        & flags and any(isinstance(n, ast.Raise) for n in ast.walk(s))]
    run_one = next(n for n in ast.walk(main)
                   if isinstance(n, ast.FunctionDef) and n.name == "run_one")
    rest = []
    for s in run_one.body:
        if isinstance(s, ast.Assign) and ast.unparse(s.targets[0]) == \
                "model_axes":
            rest.append(s)
        elif isinstance(s, ast.If) and "model_axes" in ast.unparse(s.test):
            rest.append(s)
    assert len(rules) == 4 and len(rest) == 2

    def fn(body):
        mod = ast.Module(body=[ast.FunctionDef(
            name="f", args=ast.arguments(
                posonlyargs=[], args=[ast.arg("args")], kwonlyargs=[],
                kw_defaults=[], defaults=[]),
            body=body, decorator_list=[], returns=None, type_params=[])],
            type_ignores=[])
        ns = {}
        exec(compile(ast.fix_missing_locations(mod), str(JAX_TRAIN),
                     "exec"), ns)
        return ns["f"]
    return fn(rules), fn(rest)


def _message(fn, args):
    try:
        fn(args)
    except SystemExit as e:
        return str(e)
    return None


def test_cli_flag_rules_are_the_jax_scripts():
    """Over a grid of the parallelism flags: where the JAX script refuses
    before any data loads, the port refuses with its message; where it
    does not, the port refuses the ``--devices`` remainder as the JAX script
    does, and takes the rest (tensor parallelism with the pipeline builds
    the 3-D mesh, as the JAX script's ``run_one`` does)."""
    from rovit_kan_tpu_torch.cli.train import check_flags, parse_args
    rules, remainder = _jax_rules()
    seen = set()
    for tp in (1, 2):
        for sp in (False, True):
            for fsdp in (False, True):
                for pp in (1, 2):
                    for ep in (1, 2):
                        for moe in (0, 3, 4):
                            for devices in (-1, 3, 4):
                                argv = ["--tensor_parallel", str(tp),
                                        "--pipeline_parallel", str(pp),
                                        "--expert_parallel", str(ep),
                                        "--moe_experts", str(moe),
                                        "--devices", str(devices)]
                                args = parse_args(
                                    argv + ["--sequence_parallel"] * sp
                                    + ["--fsdp"] * fsdp)
                                got = _message(check_flags, args)
                                want = _message(rules, args)
                                if want is None:
                                    want = _message(remainder, args)
                                assert got == want, argv
                                seen.add(want)
    assert len(seen) == 10   # seven rules, two remainders, no refusal


def test_flag_errors_before_data(tmp_path):
    """A refused flag exits before the data root is read."""
    from rovit_kan_tpu_torch.cli.train import main
    with pytest.raises(SystemExit, match="requires --tensor_parallel"):
        main(["--data_root", str(tmp_path / "absent"), "--cpu",
              "--sequence_parallel"])
    with pytest.raises(SystemExit, match="1 device\\(s\\) would sit idle"):
        main(["--data_root", str(tmp_path / "absent"), "--cpu",
              "--devices", "3", "--tensor_parallel", "2"])
    assert not (tmp_path / "absent").exists()


if __name__ == "__main__":
    _worker(sys.argv[1])
