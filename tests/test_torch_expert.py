"""Expert parallelism (``parallel/tensor.py::ExpertParallel``,
``make_moe_mesh``, ``moe_param_specs``) against one process and the JAX
``Trainer`` on ``make_moe_mesh(2, 2)``.

- the rules: ``moe_param_specs`` against the JAX specs leaf for leaf on the
  toy's and the MoE flagship's trees; the per-rank bytes against the JAX
  ``sharded_size``; the iota test (each rank's experts of a tree whose
  every element is its flat index against the JAX ``shard_params``'
  addressable shards, bit for bit); the mesh's and the wrapper's errors;
- one four-rank gloo launch, data 2 x expert 2 (``python
  tests/test_torch_expert.py TASK``), at the JAX test's toy (d = 32, depth
  2, 2 heads, 4 experts on block 1, 32 px): three steps (stage 4, stage 2
  frozen, stage 4) with dropout, CutMix/MixUp and the EMA against one
  process (loss 1e-5 relative, parameters and EMA 2e-6), the same with
  the JAX draws against the JAX ``Trainer`` with ``moe_param_specs``,
  which the main process runs meanwhile (losses 1e-4, parameters 2e-5);
  a forward and backward against one process (outputs 1e-5; the whole
  gradient, every leaf, the gate's and the images' included, 1e-5 of each
  leaf's largest: Adam's sign-like first steps hide a wrong gradient
  magnitude from the steps); the replicated leaves bit-equal on every rank
  and their gradients on the expert ranks; each rank's state bytes; a fit
  whose checkpoint is the one-process file, and a one-process checkpoint
  resumed under EP;
- ``cli.train --cpu --devices 2 --expert_parallel 2 --moe_experts 4``
  beside ``--devices 1``, started beside the launch.

``run_case`` and ``launch`` serve ``test_torch_pipeline.py`` as well: the
cases take the wrapper from ``case["axis"]``.
"""
from __future__ import annotations

import copy
import csv
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.models.convert import _jax_path
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.parallel.fsdp import sharded_size
from rovit_kan_tpu_torch.parallel.mesh import Mesh
from rovit_kan_tpu_torch.parallel.tensor import (
    ExpertParallel,
    moe_param_specs,
)
from rovit_kan_tpu_torch.training import optimizer as topt
from rovit_kan_tpu_torch.training.trainer import make_train_step
from test_torch_tensor import (
    ALPHA,
    LR,
    STAGES,
    _batch,
    _close,
    _config,
    _jax_draws,
    _jax_layout,
    _leaf,
    _sharded_whole,
    _trim,
)

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 240
DATA, EXPERT = 2, 2
TOY = dict(embed_dim=32, depth=2, num_heads=2, image_size=32, patch_size=16,
           kan_layers=(32, 8, 1), hidden_dim=16, moe_experts=4)


def layout_mesh(data: int, second: int, d: int = 0, x: int = 0,
                axis: str = "expert") -> Mesh:
    """Rank (d, x)'s view of a data x ``axis`` mesh, without a process
    group (enough for the layouts, which run no collective)."""
    return Mesh(data, d, torch.device("cpu"), "gloo", second_size=second,
                second_rank=x, axis_names=("data", axis))


def jax_images(n: int = 8, seed: int = 7) -> np.ndarray:
    return (np.random.RandomState(seed).rand(n, 32, 32, 3)
            .astype(np.float32) - 0.5)


LABELS = np.arange(8) % 4


def grad_loss(out, labels):
    """The JAX pipeline test's loss: mean cross-entropy of the class
    logits plus the mean KAN severity."""
    logp = torch.log_softmax(out["cls_logits"], -1)
    ce = -logp.gather(1, labels[:, None]).mean()
    return ce + out["kan_severity"].mean()


# -- the rules ----------------------------------------------------------------

def _jax_shapes(**kw):
    import jax

    from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
    size = kw.get("image_size", 224)
    model = JaxRoViTKAN(**kw, use_pallas_block=False, use_pallas_kan=False,
                        use_pallas_attention=False)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          np.zeros((1, size, size, 3), np.float32))["params"]


FLAGSHIP_MOE = dict(moe_experts=8)


@pytest.mark.parametrize("which", ["toy", "flagship"])
def test_moe_specs_match_jax(which):
    """``moe_param_specs`` against the JAX ``moe_param_specs``, leaf for
    leaf: every MoE block's w1, b1, w2, b2 on the expert dim, the gate and
    the dense leaves replicated."""
    from rovit_kan_tpu.parallel.tensor import moe_param_specs as jax_specs
    kw = TOY if which == "toy" else FLAGSHIP_MOE
    jspecs = jax_specs(_jax_shapes(**kw))
    with torch.device("meta"):
        model = RoViTKAN(**kw)
    specs = moe_param_specs(model)
    moe = [k for k, d in specs.items() if d is not None]
    assert len(moe) == 4 * (1 if which == "toy" else 6)
    for name, p in model.named_parameters():
        path, transpose = _jax_path(name, p.dim())
        assert _trim(_leaf(jspecs, path)) == _jax_layout(
            p.dim(), transpose, expert=specs[name]), name


def test_bytes_match_jax():
    """Per-rank parameter bytes of the MoE flagship and the toy over an
    expert axis of 2, against the JAX ``sharded_size``."""
    from rovit_kan_tpu.parallel.fsdp import sharded_size as jax_size
    from rovit_kan_tpu.parallel.tensor import make_moe_mesh as jax_moe
    from rovit_kan_tpu.parallel.tensor import moe_param_specs as jax_specs
    jmesh = jax_moe(1, EXPERT)
    for kw in (TOY, FLAGSHIP_MOE):
        shapes = _jax_shapes(**kw)
        ep = ExpertParallel(RoViTKAN(**kw), layout_mesh(1, EXPERT))
        got = sharded_size(ep, {}, ep.mesh, ep.specs)
        assert got == jax_size(shapes, jax_specs(shapes), jmesh)
        assert got < sum(p.numel() * 4 for p in RoViTKAN(**kw).parameters())


def test_iota_shards_are_jax_addressable_shards():
    """Every element of the toy's tree is its flat index; rank (d, e)
    holds exactly what the JAX ``shard_params`` puts on device d * 2 + e of
    ``make_moe_mesh(2, 2)``, transposed to the port's layout."""
    import jax

    from rovit_kan_tpu.parallel.tensor import make_moe_mesh as jax_moe
    from rovit_kan_tpu.parallel.tensor import moe_param_specs as jax_specs
    from rovit_kan_tpu.parallel.tensor import shard_params as jax_shard
    from rovit_kan_tpu_torch.models.convert import load_jax_params
    shapes = _jax_shapes(**TOY)
    iota = jax.tree.map(
        lambda s: np.arange(int(np.prod(s.shape)),
                            dtype=np.float32).reshape(s.shape), shapes)
    placed = jax_shard(iota, jax_moe(DATA, EXPERT), jax_specs(shapes))
    model = load_jax_params(RoViTKAN(**TOY), iota, device="cpu")
    ranks = [ExpertParallel(copy.deepcopy(model),
                            layout_mesh(DATA, EXPERT, r // EXPERT,
                                        r % EXPERT)).state_dict()
             for r in range(DATA * EXPERT)]
    for name, p in model.named_parameters():
        path, transpose = _jax_path(name, p.dim())
        shards = sorted(_leaf(placed, path).addressable_shards,
                        key=lambda s: s.device.id)
        for r in range(DATA * EXPERT):
            got = ranks[r][name].numpy()
            np.testing.assert_array_equal(got.T if transpose else got,
                                          np.asarray(shards[r].data),
                                          err_msg=f"{name} rank {r}")


def test_meshes_and_refusals_as_jax():
    from rovit_kan_tpu_torch.parallel.mesh import make_moe_mesh
    from rovit_kan_tpu_torch.parallel.tensor import shard_state
    with pytest.raises(ValueError, match="at least expert = 16 devices"):
        make_moe_mesh(-1, 16, device="cpu")
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_moe_mesh(2, 2, device="cpu")
    one = make_moe_mesh(1, 1, device="cpu")
    assert one.axis_names == ("data", "expert") and one.world == 1
    assert one.axis_size("expert") == 1 and one.axis_size("model") == 1
    mesh = layout_mesh(2, 4, 1, 3)
    assert (mesh.axis_size("expert"), mesh.axis_size("model"),
            mesh.axis_size("data"), mesh.peer("expert", 1)) == (4, 1, 2, 5)
    with pytest.raises(ValueError, match="'expert' axis"):
        ExpertParallel(RoViTKAN(**TOY), layout_mesh(1, 2, axis="model"))
    with pytest.raises(ValueError, match="needs MoE blocks"):
        ExpertParallel(RoViTKAN(**dict(TOY, moe_experts=0)),
                       layout_mesh(1, 2))
    with pytest.raises(ValueError, match="4 experts do not divide"):
        ExpertParallel(RoViTKAN(**TOY), layout_mesh(1, 3))
    # A whole one-process state cut to a rank: its experts of the
    # parameters, moments and EMA.
    from rovit_kan_tpu_torch.training.trainer import TrainState
    model = RoViTKAN(**TOY)
    opt = topt.build_optimizer(model, _config())
    opt.grad.normal_(generator=torch.Generator().manual_seed(0))
    opt.step()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = TrainState(params, opt.state_dict(), dict(params), step=1)
    ep = ExpertParallel(copy.deepcopy(model), layout_mesh(1, 2, 0, 1))
    cut = shard_state(state, ep)
    w1 = "backbone.model.blocks.1.moe.w1"
    assert torch.equal(cut.params[w1], params[w1][2:])
    assert torch.equal(cut.ema_params[w1], params[w1][2:])
    names = cut.opt_state["names"]
    sizes = [cut.params[k].numel() for k in names]
    mu = dict(zip(names, torch.split(cut.opt_state["mu"], sizes)))
    whole = dict(zip(opt.names, torch.split(opt.mu, opt._sizes)))
    assert torch.equal(mu[w1], whole[w1].view(4, -1)[2:].reshape(-1))


# -- the ranks ----------------------------------------------------------------

def make_net(model, mesh, axis: str, n_micro: int = 2):
    """``model`` on ``mesh`` under ``axis``'s wrapper (itself on None)."""
    if mesh is None:
        return model
    if axis == "expert":
        return ExpertParallel(model, mesh)
    from rovit_kan_tpu_torch.parallel.pipeline import Pipeline
    return Pipeline(model, mesh, n_micro)


def load_when_written(path) -> object:
    """``torch.load`` of ``path`` once another process has written it."""
    deadline = time.monotonic() + TIMEOUT
    while not Path(path).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"nothing written at {path}")
        time.sleep(0.1)
    return torch.load(path, weights_only=False)


def save_for_ranks(obj, path) -> None:
    """``torch.save`` to ``path`` whole or not at all (for
    ``load_when_written``)."""
    tmp = Path(f"{path}.part")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _step_on(opt, net, taught: str, out: dict) -> None:
    """Each of ``opt``'s updates from one process's gradient of that step
    (a list of whole gradients by step, which the test process writes to
    ``taught``) in place of the mesh's own, which is gathered whole into
    ``out["grads"]`` first (rank 0; None on the others)."""
    shapes = {k: p.shape for k, p in net.named_parameters()}
    own_step, teacher = opt.step, []

    def step():
        mine = dict(zip(opt.names, torch.split(opt.grad, opt._sizes)))
        out["grads"].append(net.gather_full(
            {k: g.view(shapes[k]) for k, g in mine.items()}))
        if not teacher:
            teacher.extend(load_when_written(taught))
        want = net.local(teacher[len(out["grads"]) - 1])
        for k, g in mine.items():
            g.copy_(want[k].reshape(-1))
        return own_step()
    opt.step = step


def run_steps(case: dict, mesh) -> dict:
    """``case``'s steps from its weights, on ``mesh`` under its axis's
    wrapper (None: one process). With ``case["taught"]`` (a path), each
    step's gradient is kept in ``out["grads"]``, and on the mesh each
    update takes one process's gradient instead (``_step_on``), so every
    step's gradient is the mesh's on one process's weights."""
    cfg = _config(fused_augment=case["fused_augment"],
                  ema_decay=case.get("ema_decay", 0.0))
    model = RoViTKAN(**case["model_kw"])
    model.load_state_dict(case["state_dict"])
    net = make_net(model, mesh, case["axis"])
    opt = topt.build_optimizer(net, cfg)
    step = make_train_step(net, opt, cfg, focal_alpha=ALPHA,
                           generator=torch.Generator().manual_seed(3),
                           mesh=mesh)
    out = {"losses": []}
    taught = case.get("taught")
    if taught is not None:
        out["grads"] = []
        if mesh is not None:
            _step_on(opt, net, taught, out)
    for i, (stage, live) in enumerate(STAGES):
        topt.set_hyperparams(opt, LR, 0.1 * live)
        draws = case["draws"][i] if case["draws"] else None
        m = step(case["batches"][i], stage, live, 1, draws=draws)
        out["losses"].append(float(m["total_loss"]))
        if taught is not None and mesh is None:
            out["grads"].append({k: g.clone().view_as(p) for (k, p), g in zip(
                model.named_parameters(), torch.split(opt.grad, opt._sizes))})
    if mesh is None:
        out["params"] = {k: v.clone() for k, v in model.state_dict().items()}
        out["ema"] = step.ema
        return out
    out["params"] = net.gather_full(net.state_dict())
    out["ema"] = net.gather_full(step.ema) if step.ema else None
    out["replicated"] = {k: v.clone() for k, v in net.state_dict().items()
                         if k not in net.model_sharded}
    out["bytes"] = {
        "params": sum(v.numel() * 4 for v in net.state_dict().values()),
        "mu": opt.mu.numel() * 4, "nu": opt.nu.numel() * 4,
        "ema": (sum(v.numel() * 4 for v in step.ema.values())
                if step.ema else None)}
    out["sharded_size"] = sharded_size(net, {}, mesh, net.specs)
    return out


def forward_grads(case: dict, mesh) -> dict:
    """One deterministic forward and backward of ``grad_loss`` on the
    images ``case["x"]`` (every rank takes all of them): the outputs, the
    images' gradient, each replicated leaf's gradient as this rank holds
    it, and the whole gradient (gathered over the second axis)."""
    model = RoViTKAN(**case["model_kw"])
    model.load_state_dict(case["state_dict"])
    net = make_net(model, mesh, case["axis"], case.get("n_micro", 2))
    net.eval()
    x = torch.from_numpy(case["x"]).requires_grad_()
    out = net(x)
    grad_loss(out, torch.from_numpy(LABELS)).backward()
    res = {k: out[k].detach().clone() for k in
           ("features", "cls_logits", "ordinal_logits", "mu", "log_var",
            "kan_severity")}
    res["x_grad"] = x.grad.clone()

    def grad(p):          # a head the loss does not read has none
        return torch.zeros_like(p) if p.grad is None else p.grad.clone()
    if mesh is None:
        res["grads"] = {k: grad(p) for k, p in model.named_parameters()}
        return res
    grads = {k: grad(p) for k, p in net.named_parameters()}
    res["rank_grads"] = {k: g.clone() for k, g in grads.items()
                         if k not in net.model_sharded}
    res["grads"] = net.gather_full(grads)
    return res


def fit_config(ckpt: Path, axis: str):
    """The fit of ``test_torch_fsdp.py`` (2 epochs at batch 8, the EMA on)
    at the toy's depth: 2 blocks with 4 experts on block 1, or 4 blocks
    and 2 microbatches for the pipeline."""
    from test_torch_fsdp import _fit_config
    cfg = _fit_config(ckpt)
    if axis == "expert":
        cfg.model.depth, cfg.model.moe_experts = 2, 4
    else:
        cfg.model.depth, cfg.tpu.pipeline_microbatches = 4, 2
    return cfg


def run_fit(case: dict, mesh) -> dict:
    """A 2-epoch ``Trainer.fit`` of the toy (on ``mesh``: under its axis's
    wrapper), its last state saved as ``last`` and returned whole; on the
    mesh also a one-process checkpoint (``case["resume"]``) resumed."""
    from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from test_torch_fsdp import _whole
    from test_torch_parallel import ArrayDS
    ckpt = Path(case["dir"]) / "checkpoints"
    cfg = fit_config(ckpt, case["axis"])
    train = DeviceLoader(ArrayDS(40), 8, shuffle=True, drop_last=True,
                         seed=5, device="cpu", mesh=mesh)
    val = DeviceLoader(ArrayDS(13, seed=1), 8, device="cpu", mesh=mesh)
    tr = Trainer(build_model(cfg, device="cpu", seed=0), train, val, cfg,
                 focal_alpha=ALPHA, seed=0, mesh=mesh)
    fit = tr.fit()
    out = {"val_loss": [h["total_loss"] for h in fit["history"]["val"]],
           "train_loss": [h["total_loss"] for h in fit["history"]["train"]],
           "wrapper": type(tr.sharded).__name__, "n_micro": tr.n_micro}
    tr.save_checkpoint(fit["state"], 2, fit["history"]["val"][-1],
                       name="last")
    if mesh is None:
        out["state"] = _whole(tr, fit["state"])
        return out
    out["state"] = _sharded_whole(tr, fit["state"])
    # The one-process fit runs in the test process meanwhile.
    ready = Path(case["resume"]).parent / "done"
    deadline = time.monotonic() + TIMEOUT
    while not ready.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no one-process checkpoint at {ready}")
        time.sleep(0.1)
    tr.config.paths.checkpoints_dir = Path(case["resume"])
    state, epoch = tr.resume("last")
    out["resumed"] = _sharded_whole(tr, state)
    out["resumed_epoch"] = epoch
    return out


def run_case(case: dict, mesh) -> dict:
    fn = {"steps": run_steps, "grads": forward_grads,
          "fit": run_fit}[case.get("kind", "steps")]
    return fn(case, mesh)


def _worker(task_path: str) -> None:
    from rovit_kan_tpu_torch.parallel.mesh import (
        make_moe_mesh,
        make_pipeline_mesh,
    )
    task = torch.load(task_path, weights_only=False)
    make = make_moe_mesh if task["axis"] == "expert" else make_pipeline_mesh
    mesh = make(DATA, 2, device="cpu")
    out = {name: run_case(case, mesh) for name, case in task["ranks"].items()}
    torch.save(out, Path(task_path).parent / f"out{mesh.global_rank}.pt")


# -- one launch, every case ---------------------------------------------------

def start_ranks(script: str, task: dict, tmp: Path, n: int):
    """``python script TASK`` as ``n`` gloo ranks of one job."""
    from test_torch_parallel import start_ranks as start
    return start(script, task, tmp, n)


def join(procs, tmp: Path) -> list:
    from test_torch_parallel import join_ranks
    return join_ranks(procs, tmp)


def cli_train(out: Path, *flags):
    """``cli.train --fast --synthetic --cpu`` into ``out``, started."""
    cmd = [sys.executable, "-m", "rovit_kan_tpu_torch.cli.train",
           "--data_root", str(out / "data"), "--synthetic", "--fast",
           "--cpu", "--output_dir", str(out / "out"), *flags]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))


def launch(script: str, axis: str, model_kw: dict, tmp: Path, cli_flags,
           jax_runs) -> dict:
    """The one launch of four ranks on data 2 x ``axis`` 2 running every
    case, the two CLI runs beside it, and meanwhile the one-process runs
    and ``jax_runs(cases)`` (the JAX package's results, by name) in this
    process."""
    from rovit_kan_tpu_torch.models.convert import to_jax_params
    from rovit_kan_tpu_torch.models.rovit_kan import init_weights
    batches = [_batch(i) for i in range(len(STAGES))]
    # The model's own init (a fresh module's experts are zeros, which
    # would leave them without a gradient).
    start = RoViTKAN(**dict(model_kw, dropout=0.3))
    init_weights(start, 1)
    sd = start.state_dict()
    model0 = RoViTKAN(**dict(model_kw, dropout=0.0))
    model0.load_state_dict(sd)
    ranks = {
        "steps": {"model_kw": dict(model_kw, dropout=0.3), "axis": axis,
                  "state_dict": sd, "fused_augment": True,
                  "ema_decay": 0.9, "draws": None, "batches": batches},
        "jaxdraws": {"model_kw": dict(model_kw, dropout=0.0), "axis": axis,
                     "state_dict": sd, "fused_augment": "auto",
                     "draws": _jax_draws(len(STAGES)),
                     "batches": batches},
        "grads": {"kind": "grads", "model_kw": dict(model_kw, dropout=0.0),
                  "axis": axis, "state_dict": sd, "x": jax_images()},
        "fit": {"kind": "fit", "axis": axis, "dir": str(tmp / "ranks"),
                "resume": str(tmp / "single" / "checkpoints")}}
    procs = start_ranks(script, {"axis": axis, "ranks": ranks}, tmp,
                        DATA * 2)
    clis = [cli_train(tmp / "cli", "--devices", "2", *cli_flags),
            cli_train(tmp / "cli1", "--devices", "1", *cli_flags[2:])]
    try:
        # The ranks resume this fit's checkpoint once "done" marks it.
        single = {"fit": run_fit({"dir": str(tmp / "single"),
                                  "axis": axis}, None)}
        (tmp / "single" / "done").touch()
        for k in ("steps", "jaxdraws", "grads"):
            single[k] = run_case(ranks[k], None)
        jax_out = jax_runs(ranks, to_jax_params(model0))
        out = join(procs, tmp)
        cli = [(c.communicate(timeout=TIMEOUT)[0], c.returncode)
               for c in clis]
    finally:
        for p in procs + clis:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"single": single, "ranks": out, "jax": jax_out, "tmp": tmp,
            "start": sd, "cli": cli}


def run_jax_steps(case: dict, jax_params, jmesh, specs=None,
                  **model_extra) -> dict:
    """The JAX ``Trainer`` on ``jmesh`` (``param_specs=specs``) from
    ``jax_params``: ``case``'s batches at ``STAGES``, its losses and final
    parameters (merged where the trainer pipelines)."""
    import jax
    import jax.numpy as jnp

    from rovit_kan_tpu.config import Config as JaxConfig
    from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
    from rovit_kan_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from rovit_kan_tpu.training.optimizer import \
        set_hyperparams as jax_set_hyperparams
    from rovit_kan_tpu.training.trainer import Trainer as JaxTrainer
    jcfg = JaxConfig()
    jcfg.flags.mixed_precision = False
    jcfg.data.image_size = 32
    jcfg.train.learning_rate = LR
    jcfg.tpu.pipeline_microbatches = 2
    jmodel = JaxRoViTKAN(**case["model_kw"], use_pallas_block=False,
                         use_pallas_kan=False, use_pallas_attention=False,
                         **model_extra)
    trainer = JaxTrainer(jmodel, None, None, jcfg, focal_alpha=ALPHA,
                         mesh=jmesh, seed=0, param_specs=specs)
    state = trainer.init_state(params=jax_params)
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
    params = state.params
    if getattr(trainer, "pipelined", False):
        from rovit_kan_tpu.parallel.pipeline import merge_params
        params = merge_params(params)
    return {"losses": losses, "params": jax.tree.map(np.asarray, params)}


def _jax_runs(ranks: dict, jax_params) -> dict:
    from rovit_kan_tpu.parallel.tensor import make_moe_mesh as jax_moe
    from rovit_kan_tpu.parallel.tensor import moe_param_specs as jax_specs
    jmesh = jax_moe(DATA, EXPERT)
    return {"steps": run_jax_steps(ranks["jaxdraws"], jax_params, jmesh,
                                   jax_specs(jax_params))}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert")
    return launch(__file__, "expert", TOY, tmp,
                  ["--expert_parallel", "2", "--moe_experts", "4"],
                  _jax_runs)


#: Adam's largest move of an element over the steps' two live updates
#: (``u = g / (|g| + eps)`` is at most 1 a step, times the backbone's 0.1).
NOISE_STEPS = 2 * 0.1 * LR


def close_but_key_bias(got: dict, want: dict, atol: float) -> None:
    """``_close``, but each block's key bias (the middle third of
    ``attn.qkv.bias``) within two of Adam's largest moves: softmax does not
    change when one vector is added to every key, so that bias's gradient
    is zero but for rounding (1e-9 of its leaf's largest), and Adam
    (eps 1e-8) moves it by an amount the rounding sets. Any other
    summation order of the same sums moves it differently (the MoE toy's
    data-parallel step parts there by 1.96e-6, its expert-parallel one by
    3.6e-6)."""
    _close({k: v for k, v in got.items() if not k.endswith("qkv.bias")},
           {k: v for k, v in want.items() if not k.endswith("qkv.bias")},
           atol)
    for k, v in want.items():
        if k.endswith("qkv.bias"):
            d = v.shape[0] // 3
            for part, tol in ((slice(0, d), atol), (slice(d, 2 * d),
                                                    2 * NOISE_STEPS),
                              (slice(2 * d, None), atol)):
                np.testing.assert_allclose(got[k][part].numpy(),
                                           v[part].numpy(), atol=tol,
                                           err_msg=k)


def test_steps_equal_one_process(launched):
    """Dropout, CutMix/MixUp, the EMA and the fused augment's plain version
    on; stage 4, stage 2 frozen, stage 4: every rank's losses, and rank 0's
    gathered parameters and EMA, against one process (the key biases as
    ``close_but_key_bias`` says)."""
    single = launched["single"]["steps"]
    for got in launched["ranks"]:
        np.testing.assert_allclose(got["steps"]["losses"], single["losses"],
                                   rtol=1e-5)
    got = launched["ranks"][0]["steps"]
    close_but_key_bias(got["params"], single["params"], 2e-6)
    close_but_key_bias(got["ema"], single["ema"], 2e-6)
    assert all(r["steps"]["params"] is None for r in launched["ranks"][1:])
    w1 = "backbone.model.blocks.1.moe.w1"
    assert not torch.equal(got["params"][w1], launched["start"][w1])


def assert_jax_steps(launched, noisy=None) -> None:
    """The steps with the JAX draws and dropout off against the JAX
    ``Trainer`` (losses 1e-4, parameters 2e-5) and against one process
    (losses 1e-5). ``noisy``: JAX path -> a mask of elements held within
    two of Adam's largest moves instead (``NOISE_STEPS``)."""
    from rovit_kan_tpu_torch.models.convert import to_jax_params
    from test_torch_train_step import _flat
    want = launched["jax"]["steps"]
    got = launched["ranks"][0]["jaxdraws"]
    for r in launched["ranks"]:
        np.testing.assert_allclose(r["jaxdraws"]["losses"], want["losses"],
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["losses"],
                               launched["single"]["jaxdraws"]["losses"],
                               rtol=1e-5)
    model = RoViTKAN(**launched["kw"])
    model.load_state_dict(got["params"])
    jparams = dict(_flat(want["params"]))
    flat = dict(_flat(to_jax_params(model)))
    assert flat.keys() == jparams.keys()
    for k, v in flat.items():
        mask = (noisy or {}).get(k)
        if mask is not None:
            np.testing.assert_allclose(v[mask], jparams[k][mask],
                                       atol=2 * NOISE_STEPS,
                                       err_msg="/".join(k))
            v, w = v[~mask], jparams[k][~mask]
        else:
            w = jparams[k]
        np.testing.assert_allclose(v, w, atol=2e-5, err_msg="/".join(k))


def test_steps_match_jax_trainer(launched):
    assert_jax_steps(dict(launched, kw=dict(TOY, dropout=0.0)))


def assert_whole_gradient(launched, rel: float = 1e-5) -> None:
    """Rank 0's forward and whole gradient (every leaf, and the images')
    against one process: outputs 1e-5, each gradient ``rel`` of its
    largest magnitude."""
    want = launched["single"]["grads"]
    for r in launched["ranks"]:
        for k in ("features", "cls_logits", "kan_severity"):
            np.testing.assert_allclose(r["grads"][k].numpy(),
                                       want[k].numpy(), atol=1e-5,
                                       rtol=1e-5, err_msg=k)
    got = launched["ranks"][0]["grads"]
    pairs = dict(got["grads"], images=got["x_grad"])
    wants = dict(want["grads"], images=want["x_grad"])
    assert pairs.keys() == wants.keys()
    for k, v in wants.items():
        np.testing.assert_allclose(
            pairs[k].numpy(), v.numpy(), rtol=0,
            atol=rel * max(float(v.abs().max()), 1e-30), err_msg=k)


def test_forward_and_whole_gradient_equal_one_process(launched):
    """The gate's and the images' gradients are partial on each expert
    rank until ``_ExpertInput`` sums them: a copy without that sum fails
    here (and only here: the steps' Adam hides a halved gradient)."""
    assert_whole_gradient(launched)
    gate = "backbone.model.blocks.1.moe.gate.weight"
    assert float(launched["single"]["grads"]["grads"][gate].abs().max()) > 0


def assert_replicated(launched, axis: str) -> None:
    """After the steps every rank holds the same replicated leaves, bit
    for bit; the replicated leaves' gradients agree bit for bit on the two
    ranks of a data index."""
    ranks = launched["ranks"]
    first = ranks[0]["steps"]["replicated"]
    assert first
    for r in ranks[1:]:
        assert r["steps"]["replicated"].keys() == first.keys()
        for k, v in r["steps"]["replicated"].items():
            assert torch.equal(v, first[k]), k
    for d in range(DATA):
        a, b = (ranks[d * 2 + x]["grads"]["rank_grads"] for x in range(2))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (axis, k)


def test_replicated_leaves_equal_on_every_rank(launched):
    assert_replicated(launched, "expert")


def test_state_bytes_are_sharded_size(launched):
    """Each rank's parameters, moments and EMA are ``sharded_size``'s
    bytes: the dense leaves and half of the experts."""
    full = sum(v.numel() * 4 for v in RoViTKAN(**TOY).parameters())
    experts = sum(v.numel() * 4 for k, v in RoViTKAN(**TOY).named_parameters()
                  if moe_param_specs({k: v})[k] is not None)
    for r in launched["ranks"]:
        want = r["steps"]["sharded_size"]
        assert r["steps"]["bytes"] == {"params": want, "mu": want,
                                       "nu": want, "ema": want}
        assert want == full - experts // 2


def assert_fit(launched, wrapper: str, axis: str) -> None:
    """The ranks' 2-epoch fit against the one-process fit (val losses
    1e-5, parameters 1e-5); its checkpoint holds the ranks' gathered state
    bit for bit, resumes in a one-process ``Trainer`` with the same bits
    and serves through ``load_engine``; the one-process checkpoint resumed
    on the ranks gives back its own state."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
    from test_torch_parallel import ArrayDS
    single = launched["single"]["fit"]
    fits = [r["fit"] for r in launched["ranks"]]
    assert all(f["wrapper"] == wrapper for f in fits)
    assert all(f["val_loss"] == fits[0]["val_loss"] for f in fits)
    np.testing.assert_allclose(fits[0]["val_loss"], single["val_loss"],
                               rtol=1e-5)
    _close(fits[0]["state"]["params"], single["state"]["params"], 1e-5)
    tmp = launched["tmp"]
    last = tmp / "ranks" / "checkpoints" / "last"
    ck = load_checkpoint(last)
    state = fits[0]["state"]
    assert list(ck["params"]) == list(single["state"]["params"])
    for k, v in state["params"].items():
        assert torch.equal(ck["params"][k], v), k
        assert torch.equal(ck["ema_params"][k], state["ema"][k]), k
    assert torch.equal(ck["opt_state"]["mu"], state["mu"])
    cfg = fit_config(tmp / "ranks" / "checkpoints", axis)
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


def test_fit_and_checkpoints(launched):
    assert_fit(launched, "ExpertParallel", "expert")


def assert_cli(launched, mesh_line: str, **model) -> None:
    """``cli.train --devices 2`` with the axis's flags: the JAX script's
    mesh line, one epoch CSV as ``--devices 1``'s (losses and accuracy
    1e-4), and a ``best_model`` that is the single-card file."""
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
    from test_torch_parallel import ArrayDS
    (log, rc), (log1, rc1) = launched["cli"]
    assert rc == 0, log[-4000:]
    assert rc1 == 0, log1[-4000:]
    assert mesh_line in log
    tmp = launched["tmp"]
    rows, rows1 = (list(csv.DictReader(open(
        tmp / d / "out" / "logs" / "train_epochs.csv")))
        for d in ("cli", "cli1"))
    assert [r["epoch"] for r in rows] == ["1", "2"]      # one writer
    for a, b in zip(rows, rows1):
        for k in ("train_total_loss", "val_total_loss", "val_accuracy"):
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-4), k
    best = tmp / "cli" / "out" / "checkpoints" / "best_model"
    ck = load_checkpoint(best)
    full = RoViTKAN(embed_dim=32, num_heads=2, image_size=64,
                    kan_layers=(32, 8, 1), hidden_dim=16,
                    **model).state_dict()
    assert {k: v.shape for k, v in ck["params"].items()} == \
        {k: v.shape for k, v in full.items()}
    assert ck["opt_state"]["mu"].numel() == sum(v.numel()
                                                for v in full.values())
    probs = load_engine(best, device="cpu").predict(
        ArrayDS(3, size=64).images)["cls_probs"]
    assert np.isfinite(probs).all()
    assert (tmp / "cli" / "out" / "results" / "test_metrics.json").exists()


def test_cli_train_expert_parallel(launched):
    assert_cli(launched, "Mesh: data=1 x expert=2 (expert parallel, 4 "
               "experts)", depth=2, moe_experts=4)


if __name__ == "__main__":
    _worker(sys.argv[1])
