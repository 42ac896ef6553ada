"""The port's ablation harness and its CLI against the JAX package's.

``_exp_config`` field for field for the six variants; ``save_summary_csv``
byte for byte, ``print_comparison``'s output and
``get_component_importance`` from the same result dicts; the orchestration
with both packages' ``Trainer``, ``Evaluator``, ``build_model``,
``load_model_for_evaluation`` and ``promote_staging`` replaced by the same
recording stand-ins, which must see the same calls and leave the same
files (a fresh run, a skipping run, a resumed preemption with and without
an improvement, a preempted fit); the ablation tests of
tests/test_experiments.py on the port with real training (tiny config,
CPU); and ``cli.run_ablation``'s config fields and 70/15/15 split against
what ``scripts/run_ablation.py`` sets, read from its source with ``ast``.
"""
import argparse
import ast
import contextlib
import copy
import io
import json
from pathlib import Path

import numpy as np
import pytest

import rovit_kan_tpu.experiments.ablation as jax_ablation
import rovit_kan_tpu.utils.checkpoint as jax_checkpoint
from rovit_kan_tpu.config import get_config as jax_get_config
from rovit_kan_tpu_torch.cli import run_ablation as cli
from rovit_kan_tpu_torch.config import get_config
from rovit_kan_tpu_torch.data.dataset import Loader, RoseLeafDataset, Subset
from rovit_kan_tpu_torch.data.synthetic import generate_synthetic_dataset
from rovit_kan_tpu_torch.evaluation import metrics
from rovit_kan_tpu_torch.experiments import ablation
from rovit_kan_tpu_torch.experiments.ablation import (
    CANONICAL_VARIANTS,
    CSV_FIELDS,
    AblationConfig,
    AblationExperiment,
)
from rovit_kan_tpu_torch.models.rovit_kan import build_model
from rovit_kan_tpu_torch.training.trainer import Trainer
from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint

JAX_SCRIPT = (Path(__file__).resolve().parent.parent / "scripts"
              / "run_ablation.py")


def test_variants_and_fields_match_jax():
    assert CANONICAL_VARIANTS == [
        AblationConfig(**vars(v)) for v in jax_ablation.CANONICAL_VARIANTS]
    assert CSV_FIELDS == jax_ablation.CSV_FIELDS


@pytest.mark.parametrize("variant", CANONICAL_VARIANTS,
                         ids=[v.name for v in CANONICAL_VARIANTS])
def test_exp_config_matches_jax(variant, tmp_path):
    jax_cfg, cfg = jax_get_config(), get_config()
    for c in (jax_cfg, cfg):
        c.train.epochs = 3
        c.flags.mixed_precision = False
    want = jax_ablation.AblationExperiment(
        jax_cfg, None, None, None, tmp_path)._exp_config(
        jax_ablation.AblationConfig(**vars(variant)))
    exp = AblationExperiment(cfg, None, None, None, tmp_path)
    got = exp._exp_config(variant)
    assert got.to_dict() == want.to_dict()
    assert got is not cfg and cfg.paths.checkpoints_dir != got.paths.\
        checkpoints_dir and cfg.model.with_kan


RESULTS = {
    "full_model": {"accuracy": 0.875, "macro_f1": 0.8123456789,
                   "weighted_f1": 0.86, "mae": 0.25, "spearman_rho": 0.9,
                   "brier_score": 0.2, "ece": 0.05, "ece_calibrated": 0.03,
                   "temperature": 1.25, "temperature_degenerate": False,
                   "fps": 120.5, "params": 5706394, "n_test": 40},
    "no_ordinal": {"accuracy": 0.85, "macro_f1": 0.8, "mae": 0.3,
                   "ece": 0.06, "params": 5690000, "fps": None},
    "no_kan": {"accuracy": 0.9, "macro_f1": 0.88, "mae": 0.0,
               "temperature_degenerate": True, "params": 5600000},
    "no_curriculum": {"accuracy": 0.8, "experiment": "no_curriculum"},
    "classification_only": {"accuracy": 0.7, "brier_score": 1,
                            "ece_calibrated": "n/a"},
}


@pytest.mark.parametrize("names", [list(RESULTS), ["no_kan", "no_ordinal"]],
                         ids=["with_full", "without_full"])
def test_summary_and_importance_match_jax(names, tmp_path):
    results = {n: RESULTS[n] for n in names}
    jax_exp = jax_ablation.AblationExperiment(None, None, None, None,
                                              tmp_path / "jax")
    exp = AblationExperiment(None, None, None, None, tmp_path / "port")
    printed = []
    for e in (jax_exp, exp):
        e.output_dir.mkdir()
        e.results = copy.deepcopy(results)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            e.print_comparison()
        printed.append(out.getvalue())
    assert printed[0] == printed[1] and printed[1].count("\n") == len(names) + 1
    assert exp.save_summary_csv().read_bytes() \
        == jax_exp.save_summary_csv().read_bytes()
    assert exp.get_component_importance() \
        == jax_exp.get_component_importance()


# -- the orchestration against JAX's, through recording stand-ins ---------

class Standins:
    """The same stand-ins for either package: ``build_model``, ``Trainer``,
    ``Evaluator``, ``load_model_for_evaluation`` and ``promote_staging``,
    each recording its calls with paths relative to the output directory.
    ``fit`` writes ``best_model`` (a directory stands for a committed
    checkpoint) and returns what ``fits`` scripts for the variant."""

    def __init__(self, root: Path, fits: dict):
        self.root, self.fits, self.calls = root, fits, []
        rec = self

        def rel(p):
            return Path(p).relative_to(root).as_posix()

        class Model:
            pass

        def build_model(cfg, with_ordinal=None, with_uncertainty=None,
                        with_kan=None, **kw):
            rec.calls.append(("build_model", rel(cfg.paths.checkpoints_dir),
                              with_ordinal, with_uncertainty, with_kan))
            return Model()

        class Trainer:
            pipelined = False
            sharded = None

            def __init__(self, model, train, val, cfg, logger=None,
                         focal_alpha=None, seed=42, **kw):
                self.dir = Path(cfg.paths.checkpoints_dir)
                rec.calls.append((
                    "Trainer", rel(self.dir), train, val,
                    cfg.flags.curriculum, cfg.model.with_ordinal,
                    cfg.model.with_uncertainty, cfg.model.with_kan,
                    rel(logger.log_dir), logger.experiment_name,
                    None if focal_alpha is None else list(focal_alpha),
                    seed))

            def resume(self, name):
                rec.calls.append(("resume", rel(self.dir), name))
                return "restored", 3

            def fit(self, state=None, epochs=None, start_epoch=1):
                rec.calls.append(("fit", rel(self.dir), state, epochs,
                                  start_epoch))
                (self.dir / "best_model").mkdir(exist_ok=True)
                return {"best_state": f"best:{self.dir.name}",
                        "best_val_loss": 0.5, "state": "last",
                        **rec.fits.get(self.dir.name, {})}

            @staticmethod
            def eval_params(state):
                rec.calls.append(("eval_params", state))
                return f"weights:{state}"

        class Evaluator:
            def __init__(self, model, params, test, cfg, output_dir=None):
                self.name = Path(output_dir).name
                rec.calls.append(("Evaluator", params, test,
                                  rel(output_dir)))

            def evaluate(self, run_fps=True):
                rec.calls.append(("evaluate", self.name, run_fps))
                acc = {"full_model": 0.75, "no_kan": 0.5}.get(self.name, 0.625)
                return {"accuracy": acc, "macro_f1": 0.5, "params": 7,
                        "fps": 99.5, "ece": np.float32(0.25)}

            def calibrated_metrics(self, val):
                rec.calls.append(("calibrated_metrics", self.name, val))
                return {"temperature": 1.5, "ece_calibrated": 0.125,
                        "temperature_degenerate": False}

        def load_model_for_evaluation(path, cfg, **kw):
            rec.calls.append(("load_model_for_evaluation", rel(path),
                              rel(cfg.paths.checkpoints_dir)))
            return Model(), "disk_weights"

        def promote_staging(path):
            rec.calls.append(("promote_staging", rel(path)))
            return Path(path).is_dir()

        self.build_model, self.Trainer, self.Evaluator = (
            build_model, Trainer, Evaluator)
        self.load_model_for_evaluation = load_model_for_evaluation
        self.promote_staging = promote_staging


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): (p.read_bytes() if p.is_file()
                                             else "dir")
            for p in sorted(root.rglob("*"))}


def _run(package, monkeypatch, root, fits, setup=None, variants=None):
    """One ``run_ablation_study`` of ``package`` ("jax" or "port") under the
    stand-ins: its calls, what it printed, the files it left, and the
    SystemExit it raised, if any."""
    root.mkdir(exist_ok=True)
    if setup:
        setup(root)
    s = Standins(root, fits)
    mod = jax_ablation if package == "jax" else ablation
    for name in ("build_model", "Trainer", "Evaluator",
                 "load_model_for_evaluation"):
        monkeypatch.setattr(mod, name, getattr(s, name))
    monkeypatch.setattr(jax_checkpoint if package == "jax" else mod,
                        "promote_staging", s.promote_staging)
    cfg = (jax_get_config if package == "jax" else get_config)()
    out, err = io.StringIO(), None
    with contextlib.redirect_stdout(out):
        try:
            mod.run_ablation_study(cfg, "train", "val", "test", root,
                                   focal_alpha=np.array([1.0, 2.0]),
                                   epochs=4, variants=variants, seed=7,
                                   run_fps=False)
        except SystemExit as e:
            err = str(e)
    monkeypatch.undo()
    return s.calls, out.getvalue(), _files(root), err


def _stale(name, preempt=True, cached=True):
    def setup(root):
        d = root / name
        (d / "best_model").mkdir(parents=True)
        if preempt:
            (d / "preempt_model").mkdir()
        if cached:
            (d / "test_metrics.json").write_text('{"accuracy": 0.123}')
    return setup


@pytest.mark.parametrize("case", [
    "fresh_then_skip", "resume_not_improved", "resume_improved",
    "preempted_fit"])
def test_orchestration_matches_jax(case, tmp_path, monkeypatch):
    fits, setup = {}, None
    if case == "resume_not_improved":
        fits, setup = {"no_kan": {"improved": False}}, _stale("no_kan")
    elif case == "resume_improved":
        fits, setup = {"no_kan": {"improved": True}}, _stale("no_kan")
    elif case == "preempted_fit":
        fits = {"no_ordinal": {"preempted": True}}
    runs = {}
    for package in ("jax", "port"):
        root = tmp_path / package
        runs[package] = [_run(package, monkeypatch, root, fits, setup)]
        if case == "fresh_then_skip":
            runs[package].append(_run(package, monkeypatch, root, fits))
    for jax_run, port_run in zip(runs["jax"], runs["port"]):
        for want, got in zip(jax_run, port_run):
            assert got == want
    calls, printed, files, err = runs["port"][-1]
    if case == "fresh_then_skip":
        assert printed.count("skipping retrain") == 6
        assert not any(c[0] in ("Trainer", "fit") for c in calls)
        assert json.loads(files["component_importance.json"]) == {
            "ordinal_head": 0.125, "uncertainty_head": 0.125,
            "kan_module": 0.25, "curriculum": 0.125}
    elif case == "preempted_fit":
        assert "no_ordinal" in err and "no_ordinal/test_metrics.json" \
            not in files
    else:
        assert ("resume", "no_kan", "preempt_model") in calls
        assert "no_kan/preempt_model" not in files
        assert (("load_model_for_evaluation", "no_kan/best_model", "no_kan")
                in calls) == (case == "resume_not_improved")
        assert json.loads(files["no_kan/test_metrics.json"])["accuracy"] == 0.5


# -- the JAX ablation tests on the port, with real training ---------------

def _tiny_cfg(tmp):
    cfg = get_config()
    cfg.data.image_size = 32
    cfg.train.batch_size = 8
    cfg.train.epochs = 1
    cfg.train.stage_1_epochs = 0
    cfg.train.stage_2_epochs = 0
    cfg.train.stage_3_epochs = 0
    cfg.flags.freeze_backbone_epochs = 0
    cfg.flags.mixed_precision = False
    cfg.model.depth = 1
    cfg.model.embed_dim = 32
    cfg.model.num_heads = 2
    cfg.model.hidden_dim = 16
    cfg.model.kan_layers = [32, 8, 1]
    cfg.tpu.use_pallas_attention = False
    cfg.tpu.use_pallas_kan = False
    cfg.paths.checkpoints_dir = tmp / "ckpt"
    return cfg


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exp")
    root = generate_synthetic_dataset(tmp / "data", n_per_class=6, size=32)
    cfg = _tiny_cfg(tmp)
    ds = RoseLeafDataset(root, cfg.data.class_names, cfg.data.severity_map,
                         image_size=32)
    order = np.random.RandomState(0).permutation(len(ds))
    return (cfg, tmp,
            Loader(Subset(ds, order[:16]), 8, shuffle=True, drop_last=True),
            Loader(Subset(ds, order[16:20]), 8),
            Loader(Subset(ds, order[20:]), 8))


def _experiment(loaders, out, variants, **cfg_changes):
    cfg, _, train_l, val_l, test_l = loaders
    cfg = copy.deepcopy(cfg)
    for path, value in cfg_changes.items():
        section, field = path.split("__")
        setattr(getattr(cfg, section), field, value)
    return AblationExperiment(cfg, train_l, val_l, test_l, out,
                              variants=variants, device="cpu",
                              run_fps=False)


def test_two_variants_and_skip_resume(loaders):
    _, tmp, *_ = loaders
    out = tmp / "ablation"
    variants = [AblationConfig("full_model"),
                AblationConfig("classification_only", use_ordinal=False,
                               use_uncertainty=False, use_kan=False)]
    exp = _experiment(loaders, out, variants)
    exp.run_all_experiments(epochs=1)
    assert set(exp.results) == {"full_model", "classification_only"}
    assert exp.results["classification_only"]["severity_is_fallback"]
    assert exp.results["classification_only"]["mae"] == 0.0
    for name, m in exp.results.items():
        assert m["temperature"] > 0.0, name
        assert 0.0 <= m["ece_calibrated"] <= 1.0, name
        assert 0.0 <= m["brier_calibrated"] <= 2.0, name
    meta = json.loads((out / "classification_only" / "best_model.meta.json")
                      .read_text())
    assert not meta["config"]["model"]["with_kan"]

    lines = exp.save_summary_csv().read_text().splitlines()
    assert len(lines) == 3
    header = lines[0].split(",")
    row = dict(zip(header, lines[1].split(",")))
    assert row["ece_calibrated"] != "" and float(row["temperature"]) > 0
    assert exp.get_component_importance() == {}

    exp2 = _experiment(loaders, out, variants[:1])
    m = exp2.run_single_experiment(variants[0], epochs=1)
    cached = json.loads((out / "full_model" / "test_metrics.json").read_text())
    assert m["accuracy"] == cached["accuracy"]


def test_evaluates_ema_weights(loaders, monkeypatch):
    _, tmp, *_ = loaders
    captured = {}
    real = ablation.Evaluator

    class Capturing(real):
        def __init__(self, model, params, *a, **kw):
            captured["params"] = {k: v.clone() for k, v in params.items()}
            super().__init__(model, params, *a, **kw)

    monkeypatch.setattr(ablation, "Evaluator", Capturing)
    out = tmp / "ablation_ema"
    variant = AblationConfig("full_model")
    exp = _experiment(loaders, out, [variant], train__ema_decay=0.9)
    exp.run_single_experiment(variant, epochs=1)
    ck = load_checkpoint(out / "full_model" / "best_model")
    for k, v in ck["ema_params"].items():
        np.testing.assert_allclose(captured["params"][k].numpy(), v.numpy(),
                                   atol=1e-6, err_msg=k)
    assert any(not np.allclose(ck["params"][k].numpy(), v.numpy(),
                               atol=1e-6)
               for k, v in ck["ema_params"].items())


def _forge(exp, variant, train_l, val_l, metrics, best=False):
    """One epoch through a Trainer on the variant's config, saved as a
    preemption checkpoint (and as best_model)."""
    vcfg = exp._exp_config(variant)
    (exp.output_dir / variant.name).mkdir(parents=True, exist_ok=True)
    tr = Trainer(build_model(vcfg, device="cpu"), train_l, val_l, vcfg,
                 seed=exp.seed)
    fit = tr.fit(epochs=1)
    if best:
        tr.save_checkpoint(fit["state"], 1, metrics)
    tr.save_checkpoint(fit["state"], 1, metrics, name="preempt_model")


def test_resumes_preempt_checkpoint(loaders, capsys):
    _, tmp, train_l, val_l, _ = loaders
    out = tmp / "ablation_preempt"
    variant = AblationConfig("full_model")
    exp = _experiment(loaders, out, [variant])
    _forge(exp, variant, train_l, val_l, {"total_loss": float("inf")})
    assert (out / "full_model" / "preempt_model").exists()
    capsys.readouterr()
    m = exp.run_single_experiment(variant, epochs=2)
    printed = capsys.readouterr().out
    assert "preemption checkpoint found" in printed
    assert "Epoch   2" in printed and "Epoch   1" not in printed
    assert 0.0 <= m["accuracy"] <= 1.0
    assert not (out / "full_model" / "preempt_model").exists()


def test_pending_preempt_vetoes_skip(loaders, capsys):
    _, tmp, train_l, val_l, _ = loaders
    out = tmp / "ablation_veto"
    variant = AblationConfig("full_model")
    exp = _experiment(loaders, out, [variant])
    (out / "full_model").mkdir(parents=True)
    (out / "full_model" / "test_metrics.json").write_text(
        json.dumps({"accuracy": 0.123, "experiment": "full_model"}))
    _forge(exp, variant, train_l, val_l, {"total_loss": 1.0}, best=True)
    capsys.readouterr()
    m = exp.run_single_experiment(variant, epochs=2)
    printed = capsys.readouterr().out
    assert "skipping retrain" not in printed
    assert "preemption checkpoint found" in printed
    assert m["accuracy"] != 0.123
    refreshed = json.loads(
        (out / "full_model" / "test_metrics.json").read_text())
    assert refreshed["accuracy"] == m["accuracy"]
    assert not (out / "full_model" / "preempt_model").exists()


# -- cli.run_ablation against scripts/run_ablation.py --------------------

def _jax_main():
    return next(n for n in ast.parse(JAX_SCRIPT.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _run_statements(stmts, env: dict) -> dict:
    code = compile(ast.Module(body=stmts, type_ignores=[]), str(JAX_SCRIPT),
                   "exec")
    exec(code, env)
    return env


def _between(body, first: str, stop: str):
    """The statements of ``body`` from the one whose source starts with
    ``first`` up to the one that starts with ``stop``."""
    src = [ast.unparse(s) for s in body]
    i = next(k for k, s in enumerate(src) if s.startswith(first))
    j = next(k for k, s in enumerate(src) if s.startswith(stop))
    return body[i:j]


@pytest.mark.parametrize("flags", [
    [], ["--fast"], ["--tiny"], ["--fast", "--tiny"],
    ["--epochs", "7", "--batch-size", "16", "--patience", "2",
     "--checkpoint-min-interval", "30"],
    ["--epochs", "60"], ["--epochs", "1"]])
def test_cli_config_matches_jax_script(flags):
    args = cli.parse_args(flags)
    stmts = _between(_jax_main().body, "config = get_config()",
                     "root = args.data_root")
    env = _run_statements(stmts, {"args": argparse.Namespace(
        **vars(args)), "get_config": jax_get_config})
    config, epochs, max_samples = cli.build_config(args)
    assert config.to_dict() == env["config"].to_dict()
    assert (epochs, max_samples) == (env["epochs"], env["max_samples"])
    assert config.train.batch_size == env["batch_size"]


@pytest.mark.parametrize("n,seed,max_samples", [
    (64, 42, None), (97, 0, None), (2000, 42, 1000), (10, 3, 1000)])
def test_cli_split_matches_jax_script(n, seed, max_samples):
    stmts = _between(_jax_main().body, "rng = np.random.RandomState",
                     "mesh = make_mesh")

    def subset(ds, idx):
        return np.asarray(idx)

    env = _run_statements(stmts, {
        "np": np, "args": argparse.Namespace(seed=seed), "ds": range(n),
        "max_samples": max_samples, "Subset": subset})
    got = cli.split_indices(n, seed, max_samples)
    for a, b in zip(got, (env["train_ds"], env["val_ds"], env["test_ds"])):
        np.testing.assert_array_equal(a, b)


def test_cli_tiny_synthetic_run(tmp_path, monkeypatch):
    # A bs=1 FPS of 2 + 5 forwards a variant, not 10 + 100: the run's
    # time on the CPU is what is cut, not what it computes.
    monkeypatch.setattr(metrics.fps_benchmark, "__defaults__", (2, 5, 5))
    exp = cli.main(["--data-root", str(tmp_path / "data"), "--output-dir",
                    str(tmp_path / "out"), "--synthetic", "--tiny", "--cpu",
                    "--epochs", "1", "--n-per-class", "6"])
    rows = (tmp_path / "out" / "ablation_results.csv").read_text() \
        .splitlines()
    assert len(rows) == 7 and set(exp.results) == {
        v.name for v in CANONICAL_VARIANTS}
    importance = json.loads(
        (tmp_path / "out" / "component_importance.json").read_text())
    assert set(importance) == {"ordinal_head", "uncertainty_head",
                               "kan_module", "curriculum"}
