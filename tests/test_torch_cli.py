"""The port's train and evaluate CLIs, and its logger's plots and tables,
on the CPU.

``cli.train --fast --synthetic --cpu`` writes the epoch CSV, ``best_model``
and ``test_metrics.json``; every ``config.*`` field the JAX
``scripts/train.py`` sets from the flags the port keeps (``--fast``
included) gets the same value from ``cli.train.build_config``, read from
the JAX script's own source; ``--all_seeds`` writes ``seed_summary.json``;
``--device_cache`` gives the host ``Loader``'s test metrics.
``cli.evaluate --calibrate --store_temperature`` stores T, which the port's
``load_engine`` serves with; a degenerate fit is refused and leaves the
sidecar's bytes as they were; ``--device_metrics on`` writes
``test_metrics_device.json``, which agrees with the host path;
``--preset small`` and ``base`` reach the run with their widths.
"""
import argparse
import ast
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from rovit_kan_tpu.results.logger import ExperimentLogger as JaxLogger
from rovit_kan_tpu_torch.cli import evaluate as cli_evaluate
from rovit_kan_tpu_torch.cli import train as cli_train
from rovit_kan_tpu_torch.evaluation import evaluator as evaluator_mod
from rovit_kan_tpu_torch.results.logger import CSV_COLUMNS, ExperimentLogger
from rovit_kan_tpu_torch.serving import load_engine
from rovit_kan_tpu_torch.utils.checkpoint import load_meta

JAX_TRAIN = Path(__file__).resolve().parent.parent / "scripts" / "train.py"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    metrics = cli_train.main(["--data_root", str(tmp / "data"),
                              "--output_dir", str(tmp / "out"),
                              "--synthetic", "--fast", "--cpu"])
    return tmp, metrics


def _from_flags(node, known) -> bool:
    """Whether ``node`` reads nothing but ``args.<flag>`` for flags in
    ``known`` (and constants)."""
    names = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
    flags = {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)
             and isinstance(n.value, ast.Name) and n.value.id == "args"}
    return names <= {"args"} and flags <= known


def _jax_script_config(args: argparse.Namespace) -> dict:
    """``{"config.a.b": value}`` for every assignment the JAX script's
    ``main`` makes to its config from the flags in ``args``, following its
    ``if`` statements on those flags (statements on flags the port leaves
    out are skipped)."""
    main = next(n for n in ast.parse(JAX_TRAIN.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    known, out = set(vars(args)), {}

    def ev(node):
        return eval(compile(ast.Expression(body=node), str(JAX_TRAIN),
                            "eval"), {"args": args})

    def walk(stmts):
        for s in stmts:
            if isinstance(s, ast.If) and _from_flags(s.test, known):
                walk(s.body if ev(s.test) else s.orelse)
            elif isinstance(s, ast.Assign):
                target = ast.unparse(s.targets[0])
                if target.startswith("config.") \
                        and _from_flags(s.value, known):
                    out[target] = ev(s.value)

    walk(main.body)
    return out


@pytest.mark.parametrize("flags", [
    ["--fast"],
    ["--fast", "--epochs", "3", "--batch_size", "4"],
    ["--epochs", "7", "--batch_size", "16", "--patience", "2",
     "--ema_decay", "0.99", "--checkpoint_min_interval", "30"],
    ["--epochs", "3", "--batch_size", "4", "--patience", "1",
     "--ema_decay", "0.9", "--moe_experts", "8", "--pretrained_npz", "w.npz"],
])
def test_config_fields_match_jax_script(flags):
    args = cli_train.parse_args(flags + ["--output_dir", "o"])
    want = _jax_script_config(args)
    assert len(want) >= (18 if "--fast" in flags else 8)
    cfg = cli_train.build_config(args)
    for path, value in want.items():
        assert eval(path, {"config": cfg}) == value, path


def test_train_fast_writes_outputs(trained):
    tmp, metrics = trained
    out = tmp / "out"
    with open(out / "logs" / "train_epochs.csv") as f:
        header, *rows = [ln.strip().split(",") for ln in f]
    assert header == CSV_COLUMNS and len(rows) == 2
    assert (out / "checkpoints" / "best_model" / "model.pt").exists()
    saved = json.loads((out / "results" / "test_metrics.json").read_text())
    assert saved["n_test"] == 16 and saved == json.loads(json.dumps(metrics))
    assert saved["fps"] > 0 and "fps_error" not in saved
    assert (out / "logs" / "train_curves.png").exists()
    meta = load_meta(out / "checkpoints" / "best_model")
    assert meta["config"]["model"]["embed_dim"] == 32


def test_all_seeds(trained, tmp_path):
    tmp, _ = trained
    summary = cli_train.main(["--data_root", str(tmp / "data"),
                              "--output_dir", str(tmp_path), "--fast",
                              "--cpu", "--all_seeds", "--epochs", "1"])
    saved = json.loads((tmp_path / "seed_summary.json").read_text())
    assert saved == summary
    assert set(saved["accuracy"]["per_seed"]) == {"42", "123", "999"}
    for seed in (42, 123, 999):
        assert (tmp_path / f"seed_{seed}" / "results"
                / "test_metrics.json").exists()


def test_train_device_cache_matches_host_loader(trained, tmp_path):
    """With ``--device_cache`` the set lives in a ``DeviceLoader`` (here on
    the CPU) that walks the host ``Loader``'s batches, and the ``Evaluator``
    takes its tensor batches: the same test metrics."""
    tmp, host = trained
    got = cli_train.main(["--data_root", str(tmp / "data"),
                          "--output_dir", str(tmp_path), "--fast", "--cpu",
                          "--device_cache"])
    for k in ("n_test", "confusion_matrix", "accuracy", "macro_f1"):
        assert got[k] == host[k], k
    for k in ("mae", "spearman_rho", "brier_score", "ece",
              "mean_uncertainty"):
        assert got[k] == pytest.approx(host[k], abs=1e-6), k


def _checkpoint_copy(trained, tmp_path) -> Path:
    src = trained[0] / "out" / "checkpoints"
    shutil.copytree(src / "best_model", tmp_path / "best_model")
    shutil.copy(src / "best_model.meta.json", tmp_path)
    return tmp_path / "best_model"


def _evaluate(trained, ck, out, *flags):
    return cli_evaluate.main(["--checkpoint", str(ck), "--data_root",
                              str(trained[0] / "data"), "--output_dir",
                              str(out), "--batch_size", "5", "--cpu",
                              *flags])


def test_evaluate_stores_temperature(trained, tmp_path):
    ck = _checkpoint_copy(trained, tmp_path)
    assert "temperature" not in load_meta(ck)
    ev = _evaluate(trained, ck, tmp_path / "eval", "--calibrate",
                   "--store_temperature", "--device_metrics", "off")
    assert not ev.temperature_degenerate and ev.temperature != 1.0
    assert load_meta(ck)["temperature"] == ev.temperature
    saved = json.loads((tmp_path / "eval" / "test_metrics.json").read_text())
    assert saved["temperature"] == ev.temperature
    assert "ece_precalibration" in saved
    engine = load_engine(ck, batch_size=4, device="cpu")
    assert engine.stats()["temperature"] == ev.temperature


def test_evaluate_refuses_degenerate_fit(trained, tmp_path, monkeypatch,
                                         capsys):
    ck = _checkpoint_copy(trained, tmp_path)
    sidecar = ck.parent / "best_model.meta.json"
    before = sidecar.read_bytes()
    monkeypatch.setattr(evaluator_mod, "fit_temperature_report",
                        lambda logits, labels: {
                            "temperature": 0.25, "raw_temperature": 0.06,
                            "degenerate": True, "val_accuracy": 1.0,
                            "nll": 0.0})
    ev = _evaluate(trained, ck, tmp_path / "eval", "--calibrate",
                   "--store_temperature", "--device_metrics", "off")
    assert ev.temperature_degenerate and ev.temperature == 0.25
    assert "Refusing --store_temperature" in capsys.readouterr().out
    assert sidecar.read_bytes() == before
    assert load_engine(ck, batch_size=4, device="cpu").stats()[
        "temperature"] == 1.0


def test_evaluate_device_metrics(trained, tmp_path):
    ck = trained[0] / "out" / "checkpoints" / "best_model"
    _evaluate(trained, ck, tmp_path, "--device_metrics", "off")
    _evaluate(trained, ck, tmp_path, "--device_metrics", "on")
    host = json.loads((tmp_path / "test_metrics.json").read_text())
    dev = json.loads((tmp_path / "test_metrics_device.json").read_text())
    for k in ("accuracy", "macro_f1"):
        assert dev[k] == pytest.approx(host[k], abs=1e-6), k
    assert np.array_equal(dev["confusion_matrix"], host["confusion_matrix"])
    for k in ("mae", "spearman_rho", "brier_score", "ece"):
        assert dev[k] == pytest.approx(host[k], abs=1e-5), k
    assert dev["severity_is_fallback"] is False


@pytest.mark.parametrize("preset,width", [("small", 384), ("base", 768)])
def test_wide_presets_exit(preset, width, tmp_path, monkeypatch):
    """The wide presets are no longer refused: the run gets the preset's
    config (and trains it on the plain block; "auto" fuses only d <= 192)."""
    runs = []

    def run_one(config, seed, out_dir, *rest):
        runs.append(config)
        return {"accuracy": 0.5}

    monkeypatch.setattr(cli_train, "run_one", run_one)
    assert cli_train.main(["--preset", preset, "--cpu", "--data_root",
                           str(tmp_path / "data")]) == {"accuracy": 0.5}
    (config,) = runs
    assert config.model.embed_dim == width
    assert config.model.kan_layers[0] == width


def _logged(log_cls, log_dir):
    log = log_cls(log_dir, "run")
    for epoch in (1, 2, 3):
        log.log_epoch(epoch, min(epoch, 4),
                      {"total_loss": 1.0 / epoch, "accuracy": 0.2 * epoch},
                      {"total_loss": 1.5 / epoch, "accuracy": 0.1 * epoch})
    return log


def test_logger_plot_training_curves(tmp_path):
    path = _logged(ExperimentLogger, tmp_path).plot_training_curves()
    assert path == tmp_path / "run_curves.png" and path.stat().st_size > 0


def test_logger_plot_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    log = _logged(ExperimentLogger, tmp_path)
    with pytest.warns(UserWarning, match="training curves not drawn"):
        assert log.plot_training_curves() is None
    assert not list(tmp_path.glob("*.png"))
    assert log.csv_path.exists()


def test_logger_comparison_table_matches_jax(tmp_path):
    rows = [["rovit_kan", 0.91, 0.9, 5706394], ["vgg16", 0.83, 0.8, 134e6]]
    headers = ["model", "accuracy", "macro_f1", "params"]
    got = ExperimentLogger(tmp_path / "port").save_comparison_table(
        rows, headers)
    want = JaxLogger(tmp_path / "jax").save_comparison_table(rows, headers)
    assert got.name == want.name
    assert got.read_bytes() == want.read_bytes()
