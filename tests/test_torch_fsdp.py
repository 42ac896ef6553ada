"""FSDP (``parallel/fsdp.py``) against the JAX rule, one process and JAX.

- the rule: the port's ``fsdp_param_specs`` and ``sharded_size`` against
  JAX's on the flagship's 224-px tree at n = 2, 4, 8 (56 of 173 leaves,
  the same bytes) and on the JAX test's small cases
  (``tests/test_fsdp.py``);
- the iota test: a JAX tree whose every element is its flat index, sharded
  by JAX, against the port's shards of the same tree through
  ``load_jax_params``: rank r holds what JAX's device r holds;
- one two-rank gloo launch (``python tests/test_torch_fsdp.py TASK``, as
  ``tests/test_torch_parallel.py`` starts its ranks) that runs every case:
  FSDP steps against one process (stage 2 frozen, stage 4 live,
  ``accum_steps = 2``, the EMA on: loss 1e-5 relative, parameters and EMA
  2e-6, the bounds of ``tests/test_fsdp.py``); against the JAX ``Trainer``
  with ``fsdp_param_specs`` on two devices (losses 1e-4, parameters 2e-5,
  as ``test_two_ranks_match_jax_trainer_on_two_devices``); the per-rank
  bytes of the parameters, moments and EMA against ``sharded_size``; the
  gathered-unit count; no whole sharded leaf alive between steps; the
  fused route (``block_fn = plain_vit_block``) against the unfused steps;
  a fit under FSDP against the one-process fit, its checkpoint read in one
  process and a one-process checkpoint resumed under FSDP.
"""
from __future__ import annotations

import copy
import gc
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.models.convert import _jax_path
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.ops.block_kernel import plain_vit_block
from rovit_kan_tpu_torch.parallel.fsdp import (
    FSDP,
    fsdp_param_specs,
    sharded_size,
)
from rovit_kan_tpu_torch.parallel.mesh import Mesh, make_mesh
from rovit_kan_tpu_torch.training import optimizer as topt
from rovit_kan_tpu_torch.training.trainer import make_train_step

ROOT = Path(__file__).resolve().parent.parent
KW = dict(embed_dim=32, depth=1, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
ALPHA = np.asarray([1.1, 0.9, 1.0, 1.2], np.float32)
LR = 5e-4
MIN_SIZE = 256          # the JAX test's, so the tiny model shards 10 leaves
QKV = "backbone.model.blocks.0.attn.qkv.weight"
FLAGSHIP_BYTES = {2: 11_479_784, 4: 5_806_888, 8: 2_970_440}


def cpu_mesh(n: int, rank: int = 0) -> Mesh:
    return Mesh(n, rank, torch.device("cpu"), "gloo")


# -- the rule -----------------------------------------------------------------

def _jax_flagship_shapes():
    import jax

    from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
    return jax.eval_shape(JaxRoViTKAN().init, jax.random.PRNGKey(0),
                          np.zeros((1, 224, 224, 3), np.float32))["params"]


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _jax_dim(spec):
    """The dim a JAX spec shards over "data", or None."""
    return next((d for d, ax in enumerate(spec) if ax == "data"), None)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_specs_and_bytes_match_jax_on_the_flagship(n):
    from rovit_kan_tpu.parallel.fsdp import fsdp_param_specs as jax_specs
    from rovit_kan_tpu.parallel.fsdp import sharded_size as jax_sharded_size
    from rovit_kan_tpu.parallel.mesh import make_mesh as jax_make_mesh
    shapes = _jax_flagship_shapes()
    jmesh = jax_make_mesh(n)
    jspecs = jax_specs(shapes, jmesh)
    model = RoViTKAN()
    specs = fsdp_param_specs(model, cpu_mesh(n))
    assert len(specs) == 173
    assert sum(d is not None for d in specs.values()) == 56
    for name, p in model.named_parameters():
        path, transpose = _jax_path(name, p.dim())
        jd = _jax_dim(_leaf(jspecs, path))
        want = None if jd is None else (p.dim() - 1 - jd if transpose else jd)
        assert specs[name] == want, name
    got = sharded_size(model, specs, cpu_mesh(n))
    assert got == jax_sharded_size(shapes, jspecs, jmesh) == \
        FLAGSHIP_BYTES[n]
    # The same bytes from the state_dict.
    assert sharded_size(model.state_dict(), specs, cpu_mesh(n)) == got


def test_small_cases_of_the_jax_rule():
    tree = {"big": torch.zeros(32, 96), "tall": torch.zeros(128, 17),
            "bias": torch.zeros(96), "odd": torch.zeros(17, 33)}
    specs = fsdp_param_specs(tree, cpu_mesh(8), min_size=256)
    assert specs == {"big": 1, "tall": 0, "bias": None, "odd": None}
    with pytest.raises(ValueError, match="'model' axis"):
        fsdp_param_specs({}, cpu_mesh(8), tp=True)
    tree = {"w": torch.zeros(64, 128), "b": torch.zeros(128)}
    assert sharded_size(tree, {"w": 1, "b": None}, cpu_mesh(8)) == \
        64 * 128 * 4 // 8 + 128 * 4
    # A Linear weight is the JAX kernel transposed: the JAX tie (192, 192)
    # picks JAX dim 1, the port's dim 0; the JAX qkv kernel (192, 576)
    # splits its dim 1, the port's (576, 192) its dim 0.
    lin = {"backbone.model.blocks.0.attn.proj.weight": torch.zeros(192, 192),
           "backbone.model.blocks.0.attn.qkv.weight": torch.zeros(576, 192),
           "classification_head.fc1.weight": torch.zeros(128, 192)}
    assert list(fsdp_param_specs(lin, cpu_mesh(2)).values()) == [0, 0, 1]
    assert fsdp_param_specs(lin, cpu_mesh(1)) == dict.fromkeys(lin)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_iota_shards_hold_the_jax_devices_elements(n):
    """Every element of the JAX tree is its flat index; rank r's shard of
    each leaf holds the values of JAX's device r's shard."""
    import jax
    from jax.sharding import NamedSharding

    from rovit_kan_tpu.parallel.fsdp import fsdp_param_specs as jax_specs
    from rovit_kan_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from rovit_kan_tpu_torch.models.convert import load_jax_params
    shapes = _jax_flagship_shapes()
    jmesh = jax_make_mesh(n)
    jspecs = jax_specs(shapes, jmesh)
    iota = jax.tree.map(
        lambda s: np.arange(int(np.prod(s.shape)),
                            dtype=np.float32).reshape(s.shape), shapes)
    model = load_jax_params(RoViTKAN(), iota, device="cpu")
    ranks = [FSDP(copy.deepcopy(model), cpu_mesh(n, r)).state_dict()
             for r in range(n)]
    sharded = 0
    for name, p in model.named_parameters():
        path, transpose = _jax_path(name, p.dim())
        arr = jax.device_put(_leaf(iota, path),
                             NamedSharding(jmesh, _leaf(jspecs, path)))
        shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
        if _jax_dim(_leaf(jspecs, path)) is not None:
            sharded += 1
        for r in range(n):
            want = np.asarray(shards[r].data)
            got = ranks[r][name].numpy()
            np.testing.assert_array_equal(got.T if transpose else got, want,
                                          err_msg=f"{name} rank {r}")
    assert sharded == 56


# -- the ranks ----------------------------------------------------------------

def run_ranks(task: dict, tmp: Path, n: int = 2, script: str = __file__
              ) -> list:
    """Run ``task`` on ``n`` gloo ranks of ``script``'s worker; returns
    each rank's result."""
    from test_torch_parallel import join_ranks, start_ranks
    return join_ranks(start_ranks(script, task, tmp, n), tmp)


def _config(**train) -> Config:
    cfg = Config()
    cfg.flags.mixed_precision = False
    cfg.data.image_size = 32
    cfg.train.learning_rate = LR
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def reachable_tensors(*roots) -> list:
    """Every tensor (and gradient) reachable from ``roots`` through dicts,
    sequences and object attributes."""
    seen, stack, found = set(), list(roots), []
    while stack:
        o = stack.pop()
        if id(o) in seen or o is None:
            continue
        seen.add(id(o))
        if torch.is_tensor(o):
            found.append(o)
            stack.append(o.grad)
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
        elif hasattr(o, "__dict__") and not isinstance(o, type):
            stack.extend(vars(o).values())
    return found


def whole_leaves_alive(fsdp, opt, step) -> list:
    """The sharded leaves of which a tensor of the whole shape (a weight, a
    cast, a gradient) is reachable from the training objects, apart from
    the optimizer's buffers and the EMA's shards, whose sizes
    ``test_per_rank_state_bytes_are_sharded_size`` holds (a shard of one
    leaf can have another leaf's whole shape)."""
    shapes = {fsdp.shapes[k]: k for k in fsdp.shards}
    own = {t.untyped_storage().data_ptr() for t in (
        opt.flat, opt.grad, opt.mu, opt.nu, opt.acc, opt._factors,
        *(step.ema or {}).values()) if t is not None}
    return [shapes[tuple(t.shape)]
            for t in reachable_tensors(fsdp, opt, step)
            if tuple(t.shape) in shapes
            and t.untyped_storage().data_ptr() not in own]


def run_steps(case: dict, mesh) -> dict:
    """``case``'s steps from its weights on ``mesh`` (None: one process),
    under FSDP on a mesh of 2."""
    cfg = _config(fused_augment=case["fused_augment"],
                  accum_steps=case.get("accum_steps", 1),
                  ema_decay=case.get("ema_decay", 0.0))
    model = RoViTKAN(**case["model_kw"])
    model.load_state_dict(case["state_dict"])
    gc.collect()
    if case.get("residual"):
        os.environ["ROVIT_BLOCK_RESIDUAL_BWD"] = "1"
    if case.get("fused"):
        for blk in model.backbone.model.blocks:
            blk.use_fused_block, blk.block_fn = True, plain_vit_block
    net = model if mesh is None else FSDP(
        model, mesh, fsdp_param_specs(model, mesh, min_size=MIN_SIZE))
    opt = topt.build_optimizer(net, cfg)
    step = make_train_step(net, opt, cfg, focal_alpha=ALPHA,
                           generator=torch.Generator().manual_seed(3),
                           mesh=mesh)
    out = {"losses": [], "alive": [], "peak_live": []}
    for i, (stage, live) in enumerate(case["stages"]):
        topt.set_hyperparams(opt, LR, 0.1 * live)
        draws = case["draws"][i] if case["draws"] else None
        m = step(case["batches"][i], stage, live, 1, draws=draws)
        out["losses"].append(float(m["total_loss"]))
        if mesh is not None:
            out["alive"].append(whole_leaves_alive(net, opt, step))
            out["peak_live"].append(net.peak_live)
            net.peak_live = 0
    os.environ.pop("ROVIT_BLOCK_RESIDUAL_BWD", None)
    if mesh is None:
        out["params"] = {k: v.clone() for k, v in model.state_dict().items()}
        out["ema"] = step.ema
        return out
    out["params"] = net.gather_full(net.state_dict())
    out["ema"] = net.gather_full(step.ema)
    out["bytes"] = {
        "params": sum(v.numel() * 4 for v in net.state_dict().values()),
        "mu": opt.mu.numel() * 4, "nu": opt.nu.numel() * 4,
        "ema": (sum(v.numel() * 4 for v in step.ema.values())
                if step.ema else None)}
    out["specs"] = net.specs
    return out


def _batch(step: int, b: int = 8):
    rng = np.random.RandomState(100 + step)
    images = rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, b)
    return {"images": torch.from_numpy(images),
            "labels": torch.from_numpy(labels).long(),
            "severity": torch.from_numpy(labels.astype(np.float32))}


def _fit_config(ckpt: Path, **train) -> Config:
    from test_torch_parallel import _fit_config as dp_fit_config
    cfg = dp_fit_config(ckpt)
    cfg.train.ema_decay = 0.9
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def run_fit(case: dict, mesh) -> dict:
    """A 2-epoch ``Trainer.fit`` (FSDP on a mesh of 2), its state saved as
    ``last`` and returned whole; on a mesh, also a one-process checkpoint
    resumed (``case["resume"]``), returned whole."""
    from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from test_torch_parallel import ArrayDS
    ckpt = Path(case["dir"]) / "checkpoints"
    cfg = _fit_config(ckpt)
    train = DeviceLoader(ArrayDS(40), 8, shuffle=True, drop_last=True,
                         seed=5, device="cpu", mesh=mesh)
    val = DeviceLoader(ArrayDS(13, seed=1), 8, device="cpu", mesh=mesh)

    def trainer():
        return Trainer(build_model(cfg, device="cpu", seed=0), train, val,
                       cfg, focal_alpha=ALPHA, seed=0, mesh=mesh,
                       fsdp=mesh is not None)

    tr = trainer()
    fit = tr.fit()
    tr.save_checkpoint(fit["state"], 2, fit["history"]["val"][-1],
                       name="last")
    out = {"val_loss": [h["total_loss"] for h in fit["history"]["val"]],
           "state": _whole(tr, fit["state"])}
    if mesh is not None:
        tr.config.paths.checkpoints_dir = Path(case["resume"])
        state, epoch = tr.resume("last")
        out["resumed"] = _whole(tr, state)
        out["resumed_epoch"] = epoch
        out["fsdp"] = tr.fsdp is not None
    return out


def _whole(trainer, state) -> dict:
    """``state``'s parameters, moments and EMA, whole (rank 0 under
    FSDP; None on the other ranks)."""
    if trainer.fsdp is None:
        return {"params": {k: v.clone() for k, v in state.params.items()},
                "mu": state.opt_state["mu"].clone(),
                "nu": state.opt_state["nu"].clone(),
                "ema": {k: v.clone() for k, v in state.ema_params.items()}}
    f = trainer.fsdp
    opt = f.full_opt_state(state.opt_state)
    params, ema = f.gather_full(state.params), f.gather_full(state.ema_params)
    if opt is None:
        return None
    return {"params": params, "mu": opt["mu"], "nu": opt["nu"], "ema": ema}


def _worker(task_path: str) -> None:
    task = torch.load(task_path, weights_only=False)
    mesh = make_mesh(-1, device="cpu")
    out = {}
    for name in list(task):
        out[name] = (run_fit if name == "fit" else run_steps)(task.pop(name),
                                                               mesh)
        print(f"rank {mesh.rank}: {name} done", flush=True)
    torch.save(out, Path(task_path).parent / f"out{mesh.rank}.pt")


# -- one launch, every case ---------------------------------------------------

def _jax_case():
    """The JAX ``Trainer`` with ``fsdp_param_specs`` on two CPU devices:
    its start weights, draws, losses and final parameters."""
    import jax
    import jax.numpy as jnp

    from rovit_kan_tpu.config import Config as JaxConfig
    from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
    from rovit_kan_tpu.ops.augment_kernel import _draw_factors
    from rovit_kan_tpu.parallel.fsdp import fsdp_param_specs as jax_specs
    from rovit_kan_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from rovit_kan_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from rovit_kan_tpu.training.optimizer import \
        set_hyperparams as jax_set_hyperparams
    from rovit_kan_tpu.training.trainer import Trainer as JaxTrainer
    from rovit_kan_tpu_torch.models.convert import load_jax_params
    from test_torch_mixing import jax_draws

    jcfg = JaxConfig()
    jcfg.flags.mixed_precision = False
    jcfg.data.image_size = 32
    jcfg.train.learning_rate = LR
    jmodel = JaxRoViTKAN(**dict(KW, dropout=0.0, use_pallas_block=False,
                                use_pallas_kan=False,
                                use_pallas_attention=False))
    jmesh = jax_make_mesh(2)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            np.zeros((1, 32, 32, 3), np.float32))["params"]
    trainer = JaxTrainer(jmodel, None, None, jcfg, focal_alpha=ALPHA,
                         mesh=jmesh, seed=0,
                         param_specs=jax_specs(shapes, jmesh,
                                               min_size=MIN_SIZE))
    state = trainer.init_state()
    start = jax.tree.map(np.asarray, state.params)
    stages = [(2, 0.0), (4, 1.0)]
    batches, draws, losses = [], [], []
    for i, (stage, live) in enumerate(stages):
        b = _batch(i)
        _, k_aug, k_mix, _ = jax.random.split(state.rng, 4)
        draws.append({"factors": torch.from_numpy(np.array(
            _draw_factors(k_aug, 8, 0.2, 0.2, 0.2))),
            "mix": jax_draws(k_mix, 8, 32, 32), "dropout": None})
        state = state.replace(opt_state=jax_set_hyperparams(
            state.opt_state, LR, 0.1 * live))
        jb = {"images": b["images"].numpy(),
              "labels": b["labels"].numpy().astype(np.int32),
              "severity": b["severity"].numpy()}
        state, m = trainer.train_step(state, jax_shard_batch(jb, jmesh),
                                      jnp.int32(stage), jnp.float32(live),
                                      jnp.float32(1.0))
        losses.append(float(m["total_loss"]))
        batches.append(b)
    model = load_jax_params(RoViTKAN(**KW, dropout=0.0), start, device="cpu")
    case = {"model_kw": dict(KW, dropout=0.0),
            "state_dict": model.state_dict(), "fused_augment": "auto",
            "stages": stages, "batches": batches, "draws": draws}
    return case, losses, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The one-process runs, the JAX run and the one two-rank launch."""
    tmp = tmp_path_factory.mktemp("fsdp")
    torch.manual_seed(0)
    steps = {"model_kw": dict(KW, dropout=0.3),
             "state_dict": RoViTKAN(**KW, dropout=0.3).state_dict(),
             "fused_augment": True, "accum_steps": 2, "ema_decay": 0.9,
             "stages": [(2, 0.0), (2, 0.0), (4, 1.0), (4, 1.0)],
             "batches": [_batch(i) for i in range(4)], "draws": None}
    fused = dict(steps, model_kw=dict(KW, dropout=0.0), accum_steps=1,
                 stages=[(4, 1.0), (4, 1.0)], fused=True)
    moe_kw = dict(KW, depth=2, moe_experts=4, dropout=0.0)
    moe = dict(fused, fused=False, model_kw=moe_kw,
               state_dict=RoViTKAN(**moe_kw).state_dict())
    jax_case, jax_losses, jax_params = _jax_case()
    single_dir = tmp / "single"
    single = {"steps": run_steps(steps, None),
              "unfused": run_steps(dict(fused, fused=False), None),
              "moe": run_steps(moe, None),
              "fit": run_fit({"dir": str(single_dir)}, None)}
    task = {"steps": steps, "fused": fused, "moe": moe, "jax": jax_case,
            "fused_residual": dict(fused, residual=True),
            "fit": {"dir": str(tmp / "ranks"),
                    "resume": str(single_dir / "checkpoints")}}
    ranks = run_ranks(task, tmp)
    return {"single": single, "ranks": ranks, "tmp": tmp,
            "jax": (jax_losses, jax_params), "start": steps["state_dict"]}


def _close(got: dict, want: dict, atol: float) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol,
                                   err_msg=k)


def test_fsdp_steps_equal_one_process(launched):
    """Dropout, CutMix/MixUp and the fused augment's plain version on;
    stage 2 frozen then stage 4 live, two micro-batches an update."""
    single = launched["single"]["steps"]
    for got in launched["ranks"]:
        np.testing.assert_allclose(got["steps"]["losses"], single["losses"],
                                   rtol=1e-5)
    got = launched["ranks"][0]["steps"]
    _close(got["params"], single["params"], 2e-6)
    assert launched["ranks"][1]["steps"]["params"] is None  # rank 0 keeps
    # The live steps moved the backbone: the check above is not of a no-op.
    start = launched["start"]
    assert not torch.equal(got["params"][QKV], start[QKV])


def test_fsdp_ema_is_sharded_and_equal_to_the_replicated_ema(launched):
    single = launched["single"]["steps"]
    got = launched["ranks"][0]["steps"]
    _close(got["ema"], single["ema"], 2e-6)
    assert launched["ranks"][1]["steps"]["ema"] is None    # rank 0's gather


def test_fsdp_matches_jax_trainer_on_two_devices(launched):
    from rovit_kan_tpu_torch.models.convert import to_jax_params
    from test_torch_train_step import _flat
    jax_losses, jax_params = launched["jax"]
    for got in launched["ranks"]:
        np.testing.assert_allclose(got["jax"]["losses"], jax_losses,
                                   atol=1e-4, rtol=1e-4)
    model = RoViTKAN(**KW, dropout=0.0)
    model.load_state_dict(launched["ranks"][0]["jax"]["params"])
    want = dict(_flat(jax_params))
    for k, v in dict(_flat(to_jax_params(model))).items():
        np.testing.assert_allclose(v, want[k], atol=2e-5,
                                   err_msg="/".join(k))


def test_per_rank_state_bytes_are_sharded_size(launched):
    mesh = cpu_mesh(2)
    model = RoViTKAN(**KW)
    for got in launched["ranks"]:
        s = got["steps"]
        specs = s["specs"]
        assert sum(d is not None for d in specs.values()) == 10
        want = sharded_size(model, specs, mesh)
        assert s["bytes"] == {"params": want, "mu": want, "nu": want,
                              "ema": want}
        assert want < sharded_size(model, {}, mesh)


def test_gathered_units_stay_within_the_bound(launched):
    for got in launched["ranks"]:
        for case in ("steps", "fused", "fused_residual", "moe", "jax"):
            assert got[case]["peak_live"] and all(
                n == FSDP.MAX_LIVE for n in got[case]["peak_live"])


def test_no_whole_sharded_leaf_between_steps(launched):
    for got in launched["ranks"]:
        for case in ("steps", "fused", "fused_residual", "moe", "jax"):
            assert got[case]["alive"] == [[]] * len(got[case]["alive"])


@pytest.mark.parametrize("case", ["fused", "fused_residual"])
def test_fused_route_uses_fresh_weights(launched, case):
    """The fused block (its plain versions) under FSDP against the unfused
    steps, with the recompute backward and with the saved-residual pair
    (``ROVIT_BLOCK_RESIDUAL_BWD=1``): a cast that outlived an update would
    part them at step 2."""
    want = launched["single"]["unfused"]
    got = launched["ranks"][0][case]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _close(got["params"], want["params"], 2e-6)


def test_moe_experts_shard_by_the_same_rule(launched):
    """The stacked expert weights (E, D, H) split on H, their largest
    dimension; the MoE steps equal one process's."""
    got = launched["ranks"][0]["moe"]
    assert got["specs"]["backbone.model.blocks.1.moe.w1"] == 2
    assert got["specs"]["backbone.model.blocks.1.moe.w2"] == 1
    want = launched["single"]["moe"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _close(got["params"], want["params"], 2e-6)


def test_cli_train_fsdp_two_cpu_ranks(tmp_path):
    """``cli.train --cpu --devices 2 --fsdp`` writes the epoch CSV of
    ``--devices 1 --fsdp``, which has nothing to shard over."""
    import csv

    from test_torch_parallel import _train_cli
    p, out = _train_cli(tmp_path / "fsdp", "--devices", "2", "--fsdp")
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "sharded over data=2 (ZeRO-3)" in p.stdout
    assert "FSDP state/device: params 0.1 MB (replicated: 0.2 MB)" \
        in p.stdout
    one, out1 = _train_cli(tmp_path / "one", "--devices", "1", "--fsdp")
    assert one.returncode == 0, one.stderr[-3000:]
    assert "nothing to shard over" in one.stdout
    rows = list(csv.DictReader(open(out / "logs" / "train_epochs.csv")))
    rows1 = list(csv.DictReader(open(out1 / "logs" / "train_epochs.csv")))
    assert [r["epoch"] for r in rows] == ["1", "2"]
    for a, b in zip(rows, rows1):
        for k in ("train_total_loss", "val_total_loss", "val_accuracy"):
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-4), k
    assert (out / "results" / "test_metrics.json").exists()


def test_fsdp_fit_and_checkpoints_cross_layouts(launched):
    """A fit under FSDP against the one-process fit; its checkpoint, read in
    one process, holds the ranks' gathered state bit for bit; a one-process
    checkpoint resumed under FSDP gives back its own state."""
    from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
    single = launched["single"]["fit"]
    r0, r1 = (r["fit"] for r in launched["ranks"])
    assert r0["fsdp"] and r0["val_loss"] == r1["val_loss"]
    np.testing.assert_allclose(r0["val_loss"], single["val_loss"],
                               rtol=1e-5)
    _close(r0["state"]["params"], single["state"]["params"], 1e-5)
    ck = load_checkpoint(launched["tmp"] / "ranks" / "checkpoints" / "last")
    for k, v in r0["state"]["params"].items():
        assert torch.equal(ck["params"][k], v), k
        assert torch.equal(ck["ema_params"][k], r0["state"]["ema"][k]), k
    assert torch.equal(ck["opt_state"]["mu"], r0["state"]["mu"])
    assert torch.equal(ck["opt_state"]["nu"], r0["state"]["nu"])
    assert ck["opt_state"]["names"] == topt.build_optimizer(
        RoViTKAN(**KW), _config()).names
    # The one-process checkpoint, resumed by the ranks under FSDP.
    ck = load_checkpoint(launched["tmp"] / "single" / "checkpoints" / "last")
    res = r0["resumed"]
    assert r0["resumed_epoch"] == 3 and r1["resumed"] is None
    for k, v in ck["params"].items():
        assert torch.equal(res["params"][k], v), k
        assert torch.equal(res["ema"][k], ck["ema_params"][k]), k
    assert torch.equal(res["mu"], ck["opt_state"]["mu"])
    assert torch.equal(res["nu"], ck["opt_state"]["nu"])


if __name__ == "__main__":
    _worker(sys.argv[1])
