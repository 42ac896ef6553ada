"""The port's export CLI, bench and profiling tools and the CLIs' last
single-card flags, on the CPU.

``cli.export_model --cpu --verify`` on a tiny checkpoint bakes in the
sidecar's temperature and its artifact gives the engine's outputs;
``--platforms`` is refused. ``cli.bench --cpu`` with its iteration
constants and config shrunk prints one parseable JSON line with every key;
``model_flops`` of a one-block model equals a count by hand.
``cli.profile_train --cpu`` gives every stage key and writes a trace and
an op table; ``cli.train --profile_dir`` writes a trace of its first epoch;
``--matmul_precision`` sets each of torch's three fp32 matmul modes from
both CLIs.
"""
import json

import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.cli import MATMUL_PRECISION, set_matmul_precision
from rovit_kan_tpu_torch.cli import bench as cli_bench
from rovit_kan_tpu_torch.cli import evaluate as cli_evaluate
from rovit_kan_tpu_torch.cli import export_model as cli_export
from rovit_kan_tpu_torch.cli import profile_train as cli_profile
from rovit_kan_tpu_torch.cli import train as cli_train
from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.export import load_exported
from rovit_kan_tpu_torch.models.rovit_kan import build_model
from rovit_kan_tpu_torch.serving import load_engine
from rovit_kan_tpu_torch.utils.checkpoint import save_checkpoint, update_meta


def _tiny_config(depth: int = 1) -> Config:
    cfg = Config()
    cfg.data.image_size = 32
    cfg.model.depth = depth
    cfg.model.embed_dim = 32
    cfg.model.num_heads = 2
    cfg.model.hidden_dim = 16
    cfg.model.kan_layers = [32, 8, 1]
    return cfg


def test_export_model_cli_verifies(tmp_path, capsys):
    cfg = _tiny_config()
    cfg.flags.mixed_precision = False
    ck = tmp_path / "best_model"
    save_checkpoint(ck, build_model(cfg, device="cpu", seed=4).state_dict(),
                    config=cfg)
    update_meta(ck, temperature=1.3)
    out = tmp_path / "serving.pt2"
    n = cli_export.main([str(ck), str(out), "--batch-size", "4", "--verify",
                         "--cpu"])
    printed = capsys.readouterr().out
    assert n == out.stat().st_size
    assert "T=1.3000" in printed and "Verified" in printed
    imgs = np.random.RandomState(2).randint(0, 256, (4, 32, 32, 3)) \
        .astype(np.uint8)
    got = load_exported(out)(imgs)
    want = load_engine(ck, batch_size=4, device="cpu").predict(imgs)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    with pytest.raises(ValueError, match="device"):
        cli_export.main([str(ck), str(tmp_path / "x.pt2"), "--cpu",
                         "--platforms", "cpu"])
    assert not (tmp_path / "x.pt2").exists()


BENCH_KEYS = {
    "metric", "value", "unit", "config", "fused_block", "fused_augment",
    "fps_bs1", "flops_fwd_per_image", "flops_train_per_image",
    "peak_tflops_bf16", "timing_suspect", "device", "device_ops_fwd",
    "device_ops_step"} | {
    f"{kind}_ips_bs{b}" for kind in ("fwd", "train") for b in (2, 4)} | {
    f"implied_{what}_{kind}_bs{b}" for what in ("tflops", "mfu")
    for kind in ("fwd", "train") for b in (2, 4)}


def test_bench_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(cli_bench, "bench_config", _tiny_config)
    for name, value in (("BATCHES", (2, 4)), ("FWD_WARMUP", 1),
                        ("FWD_CHUNK", 2), ("TRAIN_WARMUP", 1),
                        ("TRAIN_CHUNK", 2), ("N_CHUNKS", 2),
                        ("FPS_WARMUP", 1), ("FPS_ITERS", 2)):
        monkeypatch.setattr(cli_bench, name, value)
    res = cli_bench.main(["--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(res))
    assert set(line) == BENCH_KEYS
    assert line["metric"] == "images_per_sec_fwd_bs2"
    assert line["value"] == line["fwd_ips_bs2"] > 0
    for k in BENCH_KEYS:
        if k.endswith(("_ips_bs2", "_ips_bs4")) or k == "fps_bs1":
            assert np.isfinite(line[k]) and line[k] > 0, k
    # No device number from a CPU run.
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 0,
                              "nvidia_smi": None}
    assert line["device_ops_fwd"] is None and line["device_ops_step"] is None
    assert all(line[k] is None for k in line if k.startswith("implied_mfu"))
    assert line["timing_suspect"] is False
    assert line["flops_train_per_image"] == 3 * line["flops_fwd_per_image"]


def test_model_flops_by_hand():
    """One block at 32 px, patch 16: 4 patches, 5 tokens, d = 32, MLP 128,
    heads of width 16 to 4 classes, the KAN head [32, 8, 1] with 7 bases."""
    cfg = _tiny_config()
    patch = 2 * 4 * (16 * 16 * 3) * 32               # 196,608
    qkv = 2 * 5 * 32 * 96                            # 30,720
    scores = 2 * 5 * 5 * 32                          # q k^T, 1,600
    pv = 2 * 5 * 5 * 32                              # P v, 1,600
    proj = 2 * 5 * 32 * 32                           # 10,240
    mlp = 2 * 5 * 32 * 128 * 2                       # 81,920
    cls = 2 * (32 * 16 + 16 * 4)                     # 1,152
    ordinal = 2 * (32 * 16 + 16 * 3)                 # 1,120
    uncertainty = 2 * (32 * 16 + 16 * 2)             # 1,088
    kan = 2 * 32 * 8 * (1 + 7) + 2 * 8 * 1 * (1 + 7)  # 4,224
    want = (patch + qkv + scores + pv + proj + mlp + cls + ordinal
            + uncertainty + kan)
    assert want == 330272
    assert cli_bench.model_flops(cfg) == want
    # Each toggle drops its head's products; depth multiplies the block's.
    cfg.model.with_ordinal = cfg.model.with_uncertainty = False
    cfg.model.with_kan = False
    assert cli_bench.model_flops(cfg) == want - ordinal - uncertainty - kan
    assert cli_bench.model_flops(_tiny_config(depth=3)) == want + 2 * (
        qkv + scores + pv + proj + mlp)


STAGES = ("h2d_ms", "augment_ms", "forward_ms", "fwd_bwd_ms", "update_ms",
          "full_step_ms")


def test_profile_train_stage_keys(monkeypatch, tmp_path):
    monkeypatch.setattr(cli_bench, "bench_config", _tiny_config)
    monkeypatch.setattr(cli_bench, "N_CHUNKS", 2)
    monkeypatch.setattr(cli_profile, "TRACE_STEPS", 2)
    out = tmp_path / "profile.json"
    final = cli_profile.main(["--cpu", "--batches", "2", "4", "--iters", "1",
                              "--trace_dir", str(tmp_path / "trace"),
                              "--out", str(out), "--no_fused_augment"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(final))
    assert final["device"] == "cpu"
    for r, bs in zip(final["results"], (2, 4)):
        assert r["batch_size"] == bs and r["fused_augment"] is False
        for k in STAGES:
            assert np.isfinite(r[k]) and r[k] > 0, k
        assert set(r["pct_of_full"]) == set(STAGES[:-1])
        assert r["train_ips"] == pytest.approx(bs / r["full_step_ms"] * 1e3)
        trace = tmp_path / "trace" / f"bs{bs}"
        assert (trace / "trace.json").stat().st_size > 0
        assert "Name" in (trace / "ops.txt").read_text()
        assert r["trace"]["top_ops"]


def test_train_profile_dir_writes_trace(tmp_path):
    prof = tmp_path / "prof"
    metrics = cli_train.main(["--data_root", str(tmp_path / "data"),
                              "--output_dir", str(tmp_path / "out"),
                              "--synthetic", "--fast", "--cpu",
                              "--profile_dir", str(prof)])
    assert (prof / "trace.json").stat().st_size > 0
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert 0.0 <= metrics["accuracy"] <= 1.0
    # The first epoch ran under the trace; the fit went on from the second.
    with open(tmp_path / "out" / "logs" / "train_epochs.csv") as f:
        rows = f.read().strip().splitlines()[1:]
    assert [r.split(",")[0] for r in rows] == ["2"]


@pytest.mark.parametrize("cli,required", [
    (cli_train, ["--data_root", "d"]),
    (cli_evaluate, ["--checkpoint", "c"]),
], ids=["train", "evaluate"])
@pytest.mark.parametrize("value", sorted(MATMUL_PRECISION))
def test_matmul_precision_sets_torch_mode(cli, required, value):
    before = torch.get_float32_matmul_precision()
    try:
        args = cli.parse_args(required + ["--matmul_precision", value])
        set_matmul_precision(args.matmul_precision)
        assert torch.get_float32_matmul_precision() == \
            MATMUL_PRECISION[value]
        set_matmul_precision(cli.parse_args(required).matmul_precision)
        assert torch.get_float32_matmul_precision() == \
            MATMUL_PRECISION[value]            # no flag: left as it is
    finally:
        torch.set_float32_matmul_precision(before)
    assert MATMUL_PRECISION == {"bfloat16": "medium",
                                "tensorfloat32": "high",
                                "float32": "highest"}
