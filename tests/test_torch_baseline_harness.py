"""The port's baseline harness and its CLI against the JAX package's.

Three train steps of ``BaselineExperiment._make_steps`` on both packages
from the same initial variables, the JAX step's augment key handed to the
port as ``_draw_factors(k_aug, B, .2, .2, .2)``: each step's loss and
accuracy within 1e-4 and its gradients held leaf by leaf, the running
statistics within 1e-4 of each leaf's largest magnitude, the port's
optimizer fed the JAX gradients landing on the JAX parameters within 1e-4
of each leaf's largest (``test_train_steps_match_jax`` says why the
free-running parameters are not held so), then the eval step's
probabilities and logits within 2e-5 (a ResNet-50 with one bottleneck a
stage, and DeiT-Tiny, at 32 px, fp32). Padded rows leave the step
unchanged. The bf16 fused twin of ``_fps_step`` (through the block's plain
version on the CPU) against the JAX twin within 5e-2, on the trained
model's own tensors. A failed FPS column is recorded, not rerouted.
``run_all`` over a good model, DeiT, an unknown name and a backbone that
raises; ``save_comparison``'s CSV byte for byte against the JAX method's;
``cli.run_baselines``'s flags against ``scripts/run_baselines.py``'s (read
with ``ast``), and one CPU run of it end to end.
"""
import argparse
import ast
import copy
import json
import types
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rovit_kan_tpu.experiments.baselines as jax_harness
import rovit_kan_tpu.models.baselines as JB
from rovit_kan_tpu.config import get_config as jax_get_config
from rovit_kan_tpu.ops.augment_kernel import _draw_factors
from rovit_kan_tpu_torch.cli import run_baselines as cli
from rovit_kan_tpu_torch.config import get_config
from rovit_kan_tpu_torch.data.dataset import create_dataloaders
from rovit_kan_tpu_torch.data.synthetic import generate_synthetic_dataset
from rovit_kan_tpu_torch.evaluation import metrics
from rovit_kan_tpu_torch.experiments import baselines as harness
from rovit_kan_tpu_torch.experiments.baselines import BaselineExperiment
from rovit_kan_tpu_torch.models import baselines as PB
from rovit_kan_tpu_torch.models.convert import (
    _variable_path,
    load_baseline_variables,
    to_baseline_variables,
)
from rovit_kan_tpu_torch.training.trainer import to_device

SIZE, B = 32, 8
JAX_SCRIPT = (Path(__file__).resolve().parent.parent / "scripts"
              / "run_baselines.py")
ALPHA = np.array([0.8, 1.2, 1.0, 0.9], np.float32)


class _Raises(torch.nn.Module):
    def __init__(self, **_):
        super().__init__()
        raise RuntimeError("this backbone does not build")


@pytest.fixture(scope="module", autouse=True)
def registered():
    JB.BACKBONES["resnet_test"] = partial(JB.ResNet50,
                                          stage_sizes=(1, 1, 1, 1))
    PB.BACKBONES["resnet_test"] = partial(PB.ResNet50,
                                          stage_sizes=(1, 1, 1, 1))
    PB.BACKBONES["raises"] = _Raises
    yield
    JB.BACKBONES.pop("resnet_test")
    PB.BACKBONES.pop("resnet_test")
    PB.BACKBONES.pop("raises")


def _configs():
    jc, pc = jax_get_config(), get_config()
    for c in (jc, pc):
        c.data.image_size = SIZE
        c.train.learning_rate = 1e-3
    return jc, pc


def _batches(n=3):
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


_TRAINED = {}


def _keeping_grads(tx):
    """``tx`` whose state also holds the last gradients it was given."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _grads(model):
    """The port's gradients as a JAX params tree."""
    tree = {}
    for key, p in model.named_parameters():
        _, path, order = _variable_path(key, p.dim())
        g = p.grad.detach().numpy().copy()
        node = tree
        for q in path[:-1]:
            node = node.setdefault(q, {})
        node[path[-1]] = g.transpose(order) if order else g
    return tree


def trained(name):
    """Three steps on both packages from the JAX initial variables, and a
    replay of the JAX gradients through the port's optimizer: the per-step
    metrics and gradients of each, the final JAX variables, the port's
    model, the replayed model and both harnesses."""
    if name not in _TRAINED:
        jc, pc = _configs()
        jexp = jax_harness.BaselineExperiment(
            jc, None, None, None, "unused", epochs=1, focal_alpha=ALPHA,
            run_fps=False)
        jmodel = JB.BaselineModel(backbone_name=name, num_classes=4)
        # The JAX step's optimizer, keeping each step's gradients.
        shim = types.SimpleNamespace(**{
            k: getattr(optax, k) for k in dir(optax)
            if not k.startswith("__")})
        shim.inject_hyperparams = lambda fn: (
            lambda **kw: _keeping_grads(optax.inject_hyperparams(fn)(**kw)))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_harness, "optax", shim)
            train_step, _, tx = jexp._make_steps(jmodel)
        variables = dict(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                              jnp.zeros((1, SIZE, SIZE, 3))))
        exp = BaselineExperiment(pc, None, None, None, "unused", epochs=1,
                                 focal_alpha=ALPHA, device="cpu",
                                 run_fps=False)
        start = jax.tree.map(np.asarray, variables)
        model, replay = (load_baseline_variables(
            PB.BaselineModel(name, 4, image_size=SIZE), start, device="cpu")
            for _ in range(2))
        step, _, _ = exp._make_steps(model)
        _, _, replay_opt = exp._make_steps(replay)
        opt_state = tx.init(variables["params"])
        rng = jax.random.PRNGKey(42)
        runs = []
        for i, batch in enumerate(_batches()):
            # The JAX step's own split, to hand its augment draw over.
            _, k_aug, _ = jax.random.split(rng, 3)
            factors = np.array(_draw_factors(k_aug, B, .2, .2, .2))
            draws = {"factors": torch.from_numpy(factors), "dropout": None}
            # The weights this JAX step starts from (copied: the step may
            # reuse its input buffers).
            before = jax.tree.map(np.array, variables)
            variables, opt_state, rng, m = train_step(variables, opt_state,
                                                      rng, batch)
            got = step(to_device(batch, torch.device("cpu")), draws=draws)
            if i == 0:
                pgrads = _grads(model)
            else:
                # The port's gradient on the JAX step's own weights.
                probe = load_baseline_variables(
                    PB.BaselineModel(name, 4, image_size=SIZE), before,
                    device="cpu")
                exp._make_steps(probe)[0](
                    to_device(batch, torch.device("cpu")), draws=draws)
                pgrads = _grads(probe)
            jgrads = jax.tree.map(np.asarray, opt_state[1])
            runs.append(({k: float(v) for k, v in m.items()},
                         {k: float(v) for k, v in got.items()},
                         jgrads, pgrads))
            # The same update on the replayed model, from JAX's gradients.
            for key, p in replay.named_parameters():
                _, path, order = _variable_path(key, p.dim())
                g = jgrads
                for q in path:
                    g = g[q]
                p.grad.copy_(torch.from_numpy(np.array(
                    g.transpose(np.argsort(order)) if order else g)))
            replay_opt.learning_rate = jc.train.learning_rate
            replay_opt.step()
        _TRAINED[name] = (runs, jax.tree.map(np.asarray, variables), model,
                          replay, jexp, exp, jmodel)
    return _TRAINED[name]


def _assert_trees_close(got, want, tol, what):
    """Each leaf within ``tol`` of its largest magnitude in ``want``."""
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    want = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, a in jax.tree_util.tree_leaves_with_path(got):
        b = want[path]
        scale = max(float(np.abs(b).max()), 1e-12)
        assert np.abs(a - b).max() <= tol * scale, \
            f"{what} {jax.tree_util.keystr(path)}"


@pytest.mark.parametrize("name", ["resnet_test", "deit_tiny"])
def test_train_steps_match_jax(name):
    """Loss and accuracy of each step within 1e-4; each step's gradients
    on the weights the JAX step starts from (the first step's are the
    free-running model's, from the same start) within 1e-4 of each leaf's
    largest magnitude for the first step, 1e-3 for the later ones (the
    flagship's step test); the running statistics after three steps within
    1e-4 of each leaf's largest; the port's optimizer, as ``_make_steps``
    builds it, fed the JAX step's gradients, lands on the JAX parameters
    within 1e-4 of each leaf's largest. The free-running parameters, and so
    the later steps' gradients on them, are not held to that: Adam's first
    update of an element is +-lr whatever its gradient's size, and where
    BatchNorm's invariances make a gradient zero up to rounding (a channel
    that every following train-mode BatchNorm re-centres) the two packages'
    rounding noise draws the sign. ResNet's stem ``bn1.bias`` has three
    such elements (exact gradient below 2e-16 in float64, against the
    leaf's 0.094): after two steps they part by up to 3.7e-4, which moves
    layer1's third-step ``bn2.bias`` gradient by 2.1e-6 of its leaf's
    4.0e-4, while on the JAX weights the two gradients agree to 1.5e-9."""
    runs, variables, model, replay, *_ = trained(name)
    for i, (jm, pm, jgrads, pgrads) in enumerate(runs):
        assert abs(pm["loss"] - jm["loss"]) < 1e-4
        assert abs(pm["accuracy"] - jm["accuracy"]) < 1e-4
        _assert_trees_close(pgrads, jgrads, 1e-4 if i == 0 else 1e-3,
                            f"step {i} gradient")
    assert runs[0][0]["loss"] != runs[-1][0]["loss"]
    mine = to_baseline_variables(model)
    assert "batch_stats" in mine or name == "deit_tiny"
    if "batch_stats" in mine:
        _assert_trees_close(mine["batch_stats"], variables["batch_stats"],
                            1e-4, "running statistics")
    _assert_trees_close(to_baseline_variables(replay)["params"],
                        variables["params"], 1e-4, "replayed parameters")


@pytest.mark.parametrize("name", ["resnet_test", "deit_tiny"])
def test_eval_step_matches_jax(name):
    """On the JAX step's trained variables, running statistics included."""
    _, variables, _, _, jexp, exp, jmodel = trained(name)
    model = load_baseline_variables(PB.BaselineModel(name, 4, image_size=SIZE),
                                    variables, device="cpu")
    images = _batches()[0]["images"]
    want = jexp._eval_step_for(jmodel)(variables, {"images": images})
    got = exp._eval_step_for(model)({"images": torch.from_numpy(images)})
    for k in ("probs", "logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-5, rtol=0)


def test_padded_rows_do_not_train():
    _, pc = _configs()
    exp = BaselineExperiment(pc, None, None, None, "unused", device="cpu",
                             run_fps=False)
    batch = _batches()[-1]
    flipped = dict(batch, labels=np.where(batch["valid"] > 0,
                                          batch["labels"], 3 - batch[
                                              "labels"]).astype(np.int32))
    factors = torch.from_numpy(np.array(
        _draw_factors(jax.random.PRNGKey(3), B, .2, .2, .2)))
    runs = []
    for b in (batch, flipped):
        model = exp.build_model("resnet_test")
        step, _, _ = exp._make_steps(model)
        m = step(to_device(b, torch.device("cpu")),
                 draws={"factors": factors, "dropout": None})
        runs.append((m, model.state_dict()))
    (m1, s1), (m2, s2) = runs
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), abs=1e-6)
    assert float(m1["accuracy"]) == float(m2["accuracy"])
    for k in s1:
        torch.testing.assert_close(s1[k], s2[k], atol=1e-6, rtol=0)


def test_fps_step_policy_and_twin():
    _, variables, model, _, jexp, exp, jmodel = trained("deit_tiny")
    # "auto": the fused twin only on the card, so the plain step here.
    assert exp._fps_step("deit_tiny", model) is None
    assert exp._fps_step("resnet_test", model) is None
    exp.config.tpu.use_pallas_block = True
    jexp.config.tpu.use_pallas_block = True
    try:
        assert exp._fps_step("resnet_test", model) is None
        fps_step = exp._fps_step("deit_tiny", model)
        want_step = jexp._fps_step("deit_tiny", jmodel)
    finally:
        exp.config.tpu.use_pallas_block = "auto"
        jexp.config.tpu.use_pallas_block = "auto"
    images = _batches()[0]["images"][:2]
    got = fps_step({"images": torch.from_numpy(images)})
    want = want_step(variables, {"images": images})
    np.testing.assert_allclose(got["probs"].numpy(),
                               np.asarray(want["probs"], np.float32),
                               atol=5e-2, rtol=0)
    # The twin computes on the trained module's own tensors.
    twin = model.twin(torch.bfloat16, use_fused_block=True)
    assert twin.backbone.vit.blocks[0].use_fused_block and not twin.training
    for (k, p), (k2, q) in zip(model.named_parameters(),
                               twin.named_parameters()):
        assert k == k2 and p is q


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("baseline_data")
    cfg = get_config()
    generate_synthetic_dataset(root / "Augmented Image", n_per_class=4,
                               size=SIZE, class_names=cfg.data.class_names,
                               seed=0)
    generate_synthetic_dataset(root / "Original Image", n_per_class=2,
                               size=SIZE, class_names=cfg.data.class_names,
                               seed=1)
    return create_dataloaders(root / "Augmented Image",
                              root / "Original Image", cfg.data.class_names,
                              cfg.data.severity_map, batch_size=4, seed=0,
                              image_size=SIZE)


def test_run_all_survives_failures(tiny_data, tmp_path, monkeypatch,
                                   capsys):
    monkeypatch.setattr(metrics.fps_benchmark, "__defaults__", (1, 2, 2))
    train_l, val_l, test_l = tiny_data
    _, pc = _configs()
    exp = BaselineExperiment(
        pc, train_l, val_l, test_l, tmp_path / "out",
        model_names=["resnet_test", "nope", "raises", "deit_tiny"],
        epochs=2, focal_alpha=train_l.dataset.get_class_weights(),
        device="cpu")
    results = exp.run_all()
    printed = capsys.readouterr().out
    assert set(results) == {"resnet_test", "deit_tiny"}
    assert "skipping unknown baseline 'nope'" in printed
    assert "baseline raises FAILED" in printed
    for name, r in results.items():
        assert r["model"] == name and 0.0 <= r["accuracy"] <= 1.0
        assert r["temperature"] > 0 and r["fps"] > 0
        assert "fps_error" not in r
        assert json.loads((tmp_path / "out" / f"{name}_metrics.json")
                          .read_text()) == r
    model = exp.build_model("resnet_test")
    assert results["resnet_test"]["params"] == sum(
        p.numel() for p in model.parameters()) < sum(
        t.numel() for t in model.state_dict().values())
    rows = exp.save_comparison().read_text().splitlines()
    assert rows[0].split(",") == harness.CSV_FIELDS and len(rows) == 3


def test_fps_failure_is_recorded(tiny_data, tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("no clock")

    monkeypatch.setattr(metrics, "fps_benchmark", broken)
    train_l, val_l, test_l = tiny_data
    _, pc = _configs()
    exp = BaselineExperiment(pc, train_l, val_l, test_l, tmp_path,
                             model_names=["resnet_test"], epochs=1,
                             device="cpu")
    r = exp.run_all()["resnet_test"]
    assert r["fps"] is None and r["fps_error"] == "RuntimeError: no clock"
    assert np.isfinite(r["accuracy"])


RESULTS = {
    "deit_tiny": {"model": "deit_tiny", "accuracy": 0.875,
                  "macro_f1": 0.8123456789, "weighted_f1": 0.86,
                  "brier_score": 0.2, "ece": 0.05, "ece_calibrated": 0.03,
                  "brier_calibrated": 0.19, "temperature": 1.25,
                  "temperature_degenerate": False, "params": 5525188,
                  "fps": 120.5, "train_time_s": 3.25},
    "vgg16": {"model": "vgg16", "accuracy": 0.9, "macro_f1": 0.88,
              "weighted_f1": 0.9, "brier_score": 0.1, "ece": 0.02,
              "ece_calibrated": 0.01, "temperature": 0.25,
              "temperature_degenerate": True, "params": 134276932,
              "fps": None, "fps_error": "RuntimeError: x",
              "train_time_s": 12.0},
}
SIDECARS = {
    "resnet50_metrics.json": {"model": "resnet50", "accuracy": 0.95,
                              "params": 23516228},
    "vgg16_metrics.json": {"model": "vgg16", "accuracy": 0.1},
    "swin_tiny_metrics.json": {"model": "swin_tiny"},
    "broken_metrics.json": "{not json",
    "list_metrics.json": [1, 2],
}


def test_save_comparison_matches_jax(tmp_path):
    paths = []
    for cls, kw in ((jax_harness.BaselineExperiment, {}),
                    (BaselineExperiment, {"device": "cpu"})):
        out = tmp_path / cls.__module__.split(".")[0]
        out.mkdir()
        for fname, body in SIDECARS.items():
            (out / fname).write_text(body if isinstance(body, str)
                                     else json.dumps(body))
        exp = cls(get_config(), None, None, None, out, **kw)
        exp.results = copy.deepcopy(RESULTS)
        paths.append(exp.save_comparison())
    want, got = (p.read_bytes() for p in paths)
    assert got == want
    assert got.decode().splitlines()[1].startswith("resnet50,")


# -- cli.run_baselines against scripts/run_baselines.py ------------------

def _jax_parser() -> argparse.ArgumentParser:
    """The JAX script's parser, built by running its statements from the
    ``ArgumentParser`` to ``parse_args``."""
    main = next(n for n in ast.parse(JAX_SCRIPT.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    src = [ast.unparse(s) for s in main.body]
    i = next(k for k, s in enumerate(src) if "ArgumentParser" in s)
    j = next(k for k, s in enumerate(src) if "parse_args" in s)
    env = {"argparse": argparse, "Path": Path}
    exec(compile(ast.Module(body=main.body[i:j], type_ignores=[]),
                 str(JAX_SCRIPT), "exec"), env)
    return env["p"]


def _actions(parser):
    return {a.option_strings[0]: (a.dest, type(a).__name__, a.type,
                                  a.default, a.nargs, a.const)
            for a in parser._actions if a.option_strings[0] != "-h"}


def test_cli_flags_match_jax_script():
    """The JAX script's flags and defaults, ``--devices`` included, less
    ``--fps-timeout``, plus the port's ``--multihost`` (one rank of a
    torchrun job, as ``cli.train``'s), and one departure: ``--output-dir``
    defaults to a directory of the port's own, away from the JAX package's
    TPU records."""
    want = _actions(_jax_parser())
    assert {"--devices", "--fps-timeout"} <= set(want)
    want.pop("--fps-timeout")
    assert want["--output-dir"][3] == Path("outputs/baselines")
    want["--output-dir"] = want["--output-dir"][:3] + (
        Path("outputs/torch_baselines"),) + want["--output-dir"][4:]
    assert _actions(argparse.ArgumentParser()) == {}
    got = _actions(cli_parser())
    assert got.pop("--multihost") == ("multihost", "_StoreTrueAction", None,
                                      False, 0, True)
    assert got == want
    assert cli.parse_args([]).models is None


def cli_parser():
    """The port CLI's parser, caught where ``parse_args`` builds it."""
    caught = {}
    real = argparse.ArgumentParser.parse_args

    def catch(self, argv=None, namespace=None):
        caught["p"] = self
        return real(self, argv, namespace)

    argparse.ArgumentParser.parse_args = catch
    try:
        cli.parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught["p"]


def test_cli_cpu_synthetic_run(tmp_path, monkeypatch):
    """A run with the default ``--output-dir`` from a directory that holds
    the JAX package's records (two sidecars the run does not train, and a
    CSV): it writes its own directory and neither touches those records nor
    merges them into its table."""
    monkeypatch.chdir(tmp_path)
    records = tmp_path / "outputs" / "baselines"
    records.mkdir(parents=True)
    for fname, body in SIDECARS.items():
        (records / fname).write_text(body if isinstance(body, str)
                                     else json.dumps(body))
    (records / "baseline_comparison.csv").write_text("tpu table\n")
    before = {p.name: p.read_bytes() for p in records.iterdir()}
    exp = cli.main(["--data-root", str(tmp_path / "data"), "--cpu",
                    "--synthetic", "--image-size", str(SIZE), "--epochs",
                    "1", "--no-fps", "--batch-size", "16", "--n-per-class",
                    "6"])
    assert {p.name: p.read_bytes() for p in records.iterdir()} == before
    out = tmp_path / "outputs" / "torch_baselines"
    assert exp.output_dir == Path("outputs/torch_baselines")
    assert set(exp.results) == set(harness.DEFAULT_BASELINES)
    rows = (out / "baseline_comparison.csv").read_text().splitlines()
    assert len(rows) == 5
    assert {r.split(",")[0] for r in rows[1:]} == set(
        harness.DEFAULT_BASELINES)
    accs = [float(r.split(",")[1]) for r in rows[1:]]
    assert accs == sorted(accs, reverse=True)
    for name in harness.DEFAULT_BASELINES:
        r = json.loads((out / f"{name}_metrics.json").read_text())
        assert "fps" not in r and np.isfinite(r["ece_calibrated"])
