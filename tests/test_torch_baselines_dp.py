"""The baseline harness over a data mesh against one process and JAX.

Two gloo ranks (``python tests/test_torch_baselines_dp.py TASK``, started as
``tests/test_torch_parallel.py`` starts its ranks, every case in one
launch) take three ``BaselineExperiment`` train steps of a ResNet-50 with
one bottleneck a stage and of an EfficientNet-B0 on a subset of its blocks
(the ``tests/test_torch_baselines.py`` models), at 32 px, the last batch
with three padded rows, and are held against the same steps in one process:
each batch from the same weights: its loss and accuracy within 1e-4, its
all-reduced gradient within 1e-4 of each leaf's largest magnitude, the
BatchNorm running statistics within 1e-4 of each leaf's largest (the
moments come from the global batch, padded rows included), the update the
ranks' gradient makes; the ranks equal bit for bit. The ResNet's steps are also held against the JAX
harness's on ``make_mesh(2)`` at the tolerances of
``tests/test_torch_baseline_harness.py``. Then ``cli.run_baselines --cpu
--devices 2`` against ``--devices 1``.
"""
from __future__ import annotations

import csv
import os
import subprocess
import sys
import types
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.config import get_config
from rovit_kan_tpu_torch.experiments.baselines import BaselineExperiment
from rovit_kan_tpu_torch.models import baselines as PB
from rovit_kan_tpu_torch.parallel.mesh import make_mesh
from rovit_kan_tpu_torch.training.trainer import to_device

ROOT = Path(__file__).resolve().parent.parent
SIZE, B = 32, 8
ALPHA = np.array([0.8, 1.2, 1.0, 0.9], np.float32)
EFF_BLOCKS = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 1, 2, 5))
TEST_BACKBONES = {"resnet_test": ("ResNet50", {"stage_sizes": (1, 1, 1, 1)}),
                  "effnet_test": ("EfficientNetB0", {"blocks": EFF_BLOCKS})}
TIMEOUT = 240


def register(module) -> list:
    """The test backbones in ``module``'s registry; returns those added."""
    added = [n for n in TEST_BACKBONES if n not in module.BACKBONES]
    for n in added:
        cls, kw = TEST_BACKBONES[n]
        module.BACKBONES[n] = partial(getattr(module, cls), **kw)
    return added


@pytest.fixture(scope="module", autouse=True)
def registered():
    import rovit_kan_tpu.models.baselines as JB
    added = {m: register(m) for m in (PB, JB)}
    yield
    for m, names in added.items():
        for n in names:
            m.BACKBONES.pop(n)


def _config():
    cfg = get_config()
    cfg.data.image_size = SIZE
    cfg.train.learning_rate = 1e-3
    return cfg


def _batches(n: int = 3):
    rng = np.random.RandomState(7)
    out = []
    for i in range(n):
        valid = np.ones(B, np.float32)
        if i == n - 1:
            valid[-3:] = 0.0          # a padded tail batch
        out.append({"images": rng.randint(0, 256, (B, SIZE, SIZE, 3))
                    .astype(np.uint8),
                    "labels": rng.randint(0, 4, B).astype(np.int32),
                    "valid": valid})
    return out


def run_steps(case: dict, mesh) -> dict:
    """``case``'s steps of ``BaselineExperiment._make_steps`` from its
    weights (``state_dict``, else the seed's) on ``mesh`` (None: one
    process): each step's metrics, gradients and state after. With
    ``fresh``, every step starts from those weights, running statistics
    and a fresh optimizer."""
    exp = BaselineExperiment(_config(), None, None, None, "unused",
                             focal_alpha=ALPHA, device="cpu",
                             run_fps=False, mesh=mesh)
    model = exp.build_model(case["name"])
    if case.get("state_dict") is not None:
        model.load_state_dict(case["state_dict"])
    step, _, opt = exp._make_steps(model)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    out = {"metrics": [], "grads": [], "after": [], "start": start}
    for batch, factors in zip(case["batches"], case["factors"]):
        if case["fresh"]:
            model.load_state_dict(start)
            opt.reset()
        m = step(to_device(batch, torch.device("cpu")),
                 draws={"factors": factors, "dropout": None})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["grads"].append({k: p.grad.clone()
                             for k, p in model.named_parameters()})
        out["after"].append({k: v.clone()
                             for k, v in model.state_dict().items()})
    return out


def _worker(task_path: str) -> None:
    register(PB)
    task = torch.load(task_path, weights_only=False)
    mesh = make_mesh(-1, device="cpu")
    out = {}
    for name, case in task.items():
        out[name] = run_steps(case, mesh)
        print(f"rank {mesh.rank}: {name} done", flush=True)
    torch.save(out, Path(task_path).parent / f"out{mesh.rank}.pt")


def run_ranks(task: dict, tmp: Path, n: int = 2) -> list:
    from test_torch_fsdp import run_ranks as fsdp_run_ranks
    return fsdp_run_ranks(task, tmp, n, script=__file__)


def _jax_case():
    """Three steps of the JAX harness on ``make_mesh(2)`` from its initial
    variables, its augment keys' factors kept: the case for the ranks and
    each step's metrics and gradients, and the final variables."""
    import jax
    import jax.numpy as jnp
    import optax

    import rovit_kan_tpu.experiments.baselines as jax_harness
    import rovit_kan_tpu.models.baselines as JB
    from rovit_kan_tpu.config import get_config as jax_get_config
    from rovit_kan_tpu.ops.augment_kernel import _draw_factors
    from rovit_kan_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from rovit_kan_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from rovit_kan_tpu_torch.models.convert import load_baseline_variables
    from test_torch_baseline_harness import _keeping_grads
    jc = jax_get_config()
    jc.data.image_size = SIZE
    jc.train.learning_rate = 1e-3
    jmesh = jax_make_mesh(2)
    jexp = jax_harness.BaselineExperiment(
        jc, None, None, None, "unused", epochs=1, focal_alpha=ALPHA,
        run_fps=False, mesh=jmesh)
    jmodel = JB.BaselineModel(backbone_name="resnet_test", num_classes=4)
    # The JAX step's optimizer, keeping each step's gradients.
    shim = types.SimpleNamespace(**{
        k: getattr(optax, k) for k in dir(optax) if not k.startswith("__")})
    shim.inject_hyperparams = lambda fn: (
        lambda **kw: _keeping_grads(optax.inject_hyperparams(fn)(**kw)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_harness, "optax", shim)
        train_step, _, tx = jexp._make_steps(jmodel)
    variables = dict(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                          jnp.zeros((1, SIZE, SIZE, 3))))
    start = jax.tree.map(np.asarray, variables)
    rng = jax.random.PRNGKey(42)
    factors, metrics, grads, stats = [], [], [], []
    for batch in _batches():
        # Each step from the initial variables and a fresh optimizer.
        _, k_aug, _ = jax.random.split(rng, 3)
        factors.append(torch.from_numpy(np.array(
            _draw_factors(k_aug, B, .2, .2, .2))))
        fresh = jax.tree.map(jnp.array, start)
        after, opt_state, rng, m = train_step(
            fresh, tx.init(fresh["params"]), rng,
            jax_shard_batch(batch, jmesh))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(jax.tree.map(np.asarray, opt_state[1]))
        stats.append(jax.tree.map(np.asarray, after["batch_stats"]))
    model = load_baseline_variables(
        PB.BaselineModel("resnet_test", 4, image_size=SIZE), start,
        device="cpu")
    case = {"name": "resnet_test", "state_dict": model.state_dict(),
            "batches": _batches(), "factors": factors, "fresh": True}
    return case, metrics, grads, stats


def _factors(seed: int = 3):
    from rovit_kan_tpu_torch.ops.augment_kernel import draw_factors
    g = torch.Generator().manual_seed(seed)
    return [draw_factors(g, B) for _ in range(3)]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("baselines_dp")
    cases = {n: {"name": n, "batches": _batches(), "factors": _factors(),
                 "fresh": True} for n in TEST_BACKBONES}
    single = {n: run_steps(c, None) for n, c in cases.items()}
    jax_case, *jax_run = _jax_case()
    ranks = run_ranks({**cases, "jax": jax_case}, tmp)
    return {"single": single, "ranks": ranks, "jax": jax_run}


def _close_of_max(got: dict, want: dict, tol: float, what: str,
                  floor: float = 0.0) -> None:
    """Each tensor within ``tol`` of its largest magnitude in ``want``, or
    of ``floor`` of the largest magnitude over all of ``want`` where that
    is more."""
    assert got.keys() == want.keys(), what
    whole = max(float(b.abs().max()) for b in want.values() if b.numel())
    for k, b in want.items():
        if not b.numel():
            continue
        scale = max(float(b.abs().max()), floor * whole, 1e-12)
        gap = float((got[k].float() - b.float()).abs().max())
        assert gap <= tol * scale, f"{what} {k}: {gap:.3e} of {scale:.3e}"


#: A gradient or statistics leaf whose largest magnitude is under 1% of the
#: largest over its tree is held in units of that 1%: BatchNorm's
#: invariances make some leaves rounding noise (an EfficientNet block's
#: ``project_bn.bias``, re-centred by the next block's BatchNorm, has
#: gradients of ~1e-8 beside 0.27; the next ``expand_bn``'s running mean
#: is ~4e-9), whose own scale is no yardstick.
GRAD_FLOOR = 1e-2


@pytest.mark.parametrize("name", list(TEST_BACKBONES))
def test_two_ranks_equal_one_process(launched, name):
    """Each batch from the same weights (the third with padded rows): loss
    and accuracy 1e-4, the all-reduced gradient 1e-4 of each leaf's
    largest (``GRAD_FLOOR``), the running statistics after it 1e-4; the
    update the one-process optimizer makes from the ranks' gradient within
    1e-6 of each leaf's largest (the clip's norm sums in another thread
    order here). Free-running weights would part by Adam's +-lr first
    steps on the rounding-noise gradients
    (``tests/test_torch_baseline_harness.py``), so every batch starts from
    the same weights."""
    from rovit_kan_tpu_torch.training.optimizer import FlatAdamW
    single = launched["single"][name]
    r0, r1 = (r[name] for r in launched["ranks"])
    for i in range(3):
        for k in r0["after"][i]:
            assert torch.equal(r0["after"][i][k], r1["after"][i][k]), k
        for k in ("loss", "accuracy"):
            assert abs(r0["metrics"][i][k] - single["metrics"][i][k]) \
                < 1e-4, (i, k)
        _close_of_max(r0["grads"][i], single["grads"][i], 1e-4,
                      f"batch {i} gradient", floor=GRAD_FLOOR)
        stats = {k: v for k, v in single["after"][i].items()
                 if k.endswith(("running_mean", "running_var"))}
        assert stats
        _close_of_max({k: r0["after"][i][k] for k in stats}, stats, 1e-4,
                      f"batch {i} running statistics", floor=GRAD_FLOOR)
        model = PB.BaselineModel(name, 4, image_size=SIZE)
        model.load_state_dict(r0["start"])
        cfg = _config()
        opt = FlatAdamW(model, cfg.train.learning_rate, backbone_scale=1.0,
                        weight_decay=cfg.train.weight_decay,
                        clip=cfg.flags.gradient_clip)
        for k, p in model.named_parameters():
            p.grad.copy_(r0["grads"][i][k])
        opt.step()
        _close_of_max({k: r0["after"][i][k] for k, _ in
                       model.named_parameters()},
                      {k: v.detach() for k, v in model.named_parameters()},
                      1e-6, f"batch {i} update")
    assert single["metrics"][0]["loss"] != single["metrics"][-1]["loss"]


def test_two_ranks_match_jax_harness_on_two_devices(launched):
    """Each batch from the JAX initial variables and a fresh optimizer on
    both sides (the third batch with padded rows): loss and accuracy 1e-4,
    the gradient 1e-4 of each leaf's largest (``GRAD_FLOOR``), the running
    statistics after it 1e-4 of each leaf's largest (both
    ``GRAD_FLOOR``)."""
    from rovit_kan_tpu_torch.models.convert import to_baseline_variables
    from test_torch_baseline_harness import _grads
    metrics, grads, stats = launched["jax"]
    got = launched["ranks"][0]["jax"]
    model = PB.BaselineModel("resnet_test", 4, image_size=SIZE)

    def flat(tree):
        import jax
        return {jax.tree_util.keystr(k): torch.from_numpy(np.asarray(v))
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    for i, (jm, pm) in enumerate(zip(metrics, got["metrics"])):
        assert abs(pm["loss"] - jm["loss"]) < 1e-4
        assert abs(pm["accuracy"] - jm["accuracy"]) < 1e-4
        for k, p in model.named_parameters():
            p.grad = got["grads"][i][k]
        _close_of_max(flat(_grads(model)), flat(grads[i]), 1e-4,
                      f"batch {i} gradient", floor=GRAD_FLOOR)
        model.load_state_dict(got["after"][i])
        _close_of_max(flat(to_baseline_variables(model)["batch_stats"]),
                      flat(stats[i]), 1e-4,
                      f"batch {i} running statistics", floor=GRAD_FLOOR)


def test_cli_run_baselines_two_cpu_ranks(tmp_path):
    """``cli.run_baselines --cpu --devices 2`` gives the ``--devices 1``
    CSV: the same columns and rows, the metrics within 1e-4, the
    temperatures within 1e-3; rank 0 alone writes."""
    def run(devices):
        out = tmp_path / f"out{devices}"
        p = subprocess.run(
            [sys.executable, "-m", "rovit_kan_tpu_torch.cli.run_baselines",
             "--data-root", str(tmp_path / "data"), "--output-dir",
             str(out), "--synthetic", "--image-size", str(SIZE),
             "--epochs", "1", "--no-fps", "--batch-size", "16",
             "--n-per-class", "6", "--models", "resnet50", "deit_tiny",
             "--cpu", "--devices", str(devices)], cwd=ROOT,
            capture_output=True, text=True, timeout=TIMEOUT,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
        return list(csv.DictReader(open(out / "baseline_comparison.csv")))

    two, one = run(2), run(1)
    assert [r["model"] for r in two] == [r["model"] for r in one]
    assert two[0].keys() == one[0].keys()
    for a, b in zip(two, one):
        assert a["params"] == b["params"]
        for k in ("accuracy", "macro_f1", "weighted_f1", "brier_score",
                  "ece", "ece_calibrated"):
            assert float(a[k]) == pytest.approx(float(b[k]), abs=1e-4), k
        assert float(a["temperature"]) == pytest.approx(
            float(b["temperature"]), abs=1e-3)


if __name__ == "__main__":
    _worker(sys.argv[1])
