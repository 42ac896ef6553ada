"""Data parallelism on torch.distributed against one device and the JAX mesh.

The port runs one process per card; a step on N ranks must be the step of
one device on the whole global batch (``tests/test_parallel.py`` holds the
same for the JAX SPMD step). Here the ranks are gloo processes on the CPU:
this file starts them itself (``python tests/test_torch_parallel.py TASK``
with torchrun's variables set), each on its own port, and reads what they
saved. Every start has a time limit, so a hung collective fails its test.

- the plans: ``local_batch_slice`` and the sharded ``DeviceLoader``'s train
  and eval plans and shards, against the JAX functions;
- one-device equivalence: two ranks against one process on the global
  batch, dropout, CutMix/MixUp and the fused augment's plain version on:
  loss 1e-5 relative and parameters 1e-6 after two steps (the JAX test's
  bounds), the ranks' parameters equal bit for bit after every step;
- against JAX: the same two-rank step against the JAX ``Trainer.train_step``
  on ``make_mesh(2)`` with its draws handed in (loss 1e-4, parameters 2e-5,
  as ``tests/test_torch_train_step.py``);
- two-process ``Trainer.fit`` over the sharded and the replicated
  ``DeviceLoader``, checkpoints written by rank 0 alone, the temperature
  broadcast, ``load_engine``; ``cli.train --cpu --devices 2`` and
  ``cli.run_ablation --cpu --devices 2``;
- refusals, and a mesh of 1 that runs no collective.
"""
from __future__ import annotations

import os
import random
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.config import Config
from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN, build_model
from rovit_kan_tpu_torch.parallel import mesh as pmesh
from rovit_kan_tpu_torch.parallel import multihost
from rovit_kan_tpu_torch.parallel.mesh import Mesh, make_mesh
from rovit_kan_tpu_torch.training import optimizer as topt
from rovit_kan_tpu_torch.training.trainer import Trainer, make_train_step

ROOT = Path(__file__).resolve().parent.parent
KW = dict(embed_dim=32, depth=1, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
ALPHA = np.asarray([1.1, 0.9, 1.0, 1.2], np.float32)
LR = 5e-4
TIMEOUT = 240


# -- the ranks ---------------------------------------------------------------

def _ephemeral_floor() -> int:
    """The lowest port the kernel gives an outgoing connection."""
    try:
        return int(Path("/proc/sys/net/ipv4/ip_local_port_range")
                   .read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _free_port() -> int:
    """A port for rank 0's store, free when it is drawn. It is drawn at
    random below the ephemeral range: a port that ``bind(0)`` hands out and
    the caller releases is free for the kernel to give again, to another
    launch's ``bind(0)`` or to any outgoing connection (each pair of gloo
    ranks running beside it opens some), before rank 0 binds it seconds
    later. Below that range only another explicit bind can take it, and
    ``join_ranks`` starts a job whose store found its port taken again on
    a fresh one."""
    rng = random.SystemRandom()
    top = _ephemeral_floor()
    while True:
        port = rng.randrange(max(1024, top - 16384), top)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


#: What a rank's log says when rank 0's store found its port taken.
_ADDR_IN_USE = re.compile(r"EADDRINUSE|address already in use", re.I)


class RankProcs(list):
    """The ``n`` processes of one gloo job, ``cmd`` with torchrun's
    variables set, each logging to ``rank{r}.log`` in ``log_dir``."""

    def __init__(self, cmd: list, n: int, log_dir: Path):
        super().__init__()
        self.cmd, self.n, self.log_dir = cmd, n, Path(log_dir)
        self.start()

    def start(self) -> None:
        """Starts the ranks, on a fresh port."""
        env = dict(os.environ, WORLD_SIZE=str(self.n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(ROOT),
                                               str(ROOT / "tests")]))
        self[:] = []
        for r in range(self.n):
            with open(self.log_dir / f"rank{r}.log", "w") as log:
                self.append(subprocess.Popen(
                    self.cmd, cwd=ROOT,
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=log, stderr=subprocess.STDOUT))

    def logs(self) -> list:
        return [(self.log_dir / f"rank{r}.log").read_text(errors="replace")
                for r in range(self.n)]


def start_ranks(script, task: dict, tmp: Path, n: int) -> RankProcs:
    """``python script TASK`` as ``n`` gloo ranks of one job, started; the
    task is saved in ``tmp``, where each rank writes ``out{r}.pt``."""
    path = tmp / "task.pt"
    torch.save(task, path)
    return RankProcs([sys.executable, str(script), str(path)], n, tmp)


def join_ranks(procs: RankProcs, tmp: Path, tries: int = 3) -> list:
    """Each rank's result, once every rank has exited 0. The ranks are
    stopped when none of their logs has grown for ``TIMEOUT`` seconds, so a
    hung collective fails while a job that prints as it goes (a line a case)
    may take longer under load; when one rank fails, the others, which
    would wait for it in a collective, are stopped at once. Where a log
    shows that rank 0's store found its port taken (``_free_port``), the
    job starts again on a fresh port, up to ``tries`` starts in all."""
    def logged() -> int:
        return sum((procs.log_dir / f"rank{r}.log").stat().st_size
                   for r in range(procs.n))

    for attempt in range(tries):
        seen, deadline = -1, 0.0
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)):
            size = logged()
            if size != seen:
                seen, deadline = size, time.monotonic() + TIMEOUT
            if time.monotonic() > deadline:
                break
            time.sleep(0.1)
        late = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        logs = procs.logs()
        if all(p.returncode == 0 for p in procs):
            return [torch.load(tmp / f"out{r}.pt", weights_only=False)
                    for r in range(procs.n)]
        if (late or attempt + 1 == tries
                or not any(_ADDR_IN_USE.search(log) for log in logs)):
            break
        procs.start()
    failed = "\n".join(
        f"rank {r}: exit {p.returncode}"
        + (f" (stopped: no log line for {TIMEOUT} s)" if r in late else "")
        + f"\n{logs[r][-4000:]}" for r, p in enumerate(procs)
        if p.returncode != 0)
    raise AssertionError(failed)


def run_ranks(task: dict, tmp: Path, n: int = 2) -> list:
    """Run ``task`` on ``n`` gloo ranks; returns each rank's result."""
    return join_ranks(start_ranks(__file__, task, tmp, n), tmp)


def _config(**train) -> Config:
    cfg = Config()
    cfg.flags.mixed_precision = False
    cfg.data.image_size = 32
    cfg.train.learning_rate = LR
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def run_steps(task: dict, mesh) -> dict:
    """``task``'s steps from its weights on ``mesh`` (None: one process)."""
    cfg = _config(fused_augment=task["fused_augment"])
    model = RoViTKAN(**task["model_kw"])
    model.load_state_dict(task["state_dict"])
    opt = topt.build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg, focal_alpha=ALPHA,
                           generator=torch.Generator().manual_seed(3),
                           mesh=mesh)
    out = {"losses": [], "accuracy": [], "params": []}
    for i, (stage, live) in enumerate(task["stages"]):
        topt.set_hyperparams(opt, LR, 0.1 * live)
        draws = task["draws"][i] if task["draws"] else None
        m = step(task["batches"][i], stage, live, 1, draws=draws)
        out["losses"].append(float(m["total_loss"]))
        out["accuracy"].append(float(m["accuracy"]))
        out["params"].append(opt.flat.clone())
    out["state_dict"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


class ArrayDS:
    """Seeded uint8 images with labels and severities."""

    def __init__(self, n: int, seed: int = 0, size: int = 32):
        rng = np.random.RandomState(seed)
        self.images = rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
        self.labels = rng.randint(0, 4, n)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i]), float(self.labels[i])


def _fit_config(ckpt: Path) -> Config:
    cfg = _config(batch_size=8, epochs=2, stage_1_epochs=1,
                  stage_2_epochs=1, stage_3_epochs=1)
    cfg.flags.freeze_backbone_epochs = 1
    cfg.paths.checkpoints_dir = ckpt
    m = cfg.model
    m.embed_dim, m.depth, m.num_heads, m.hidden_dim = 32, 1, 2, 16
    m.kan_layers = [32, 8, 1]
    return cfg


def run_fit(task: dict, mesh) -> dict:
    """A 2-epoch ``Trainer.fit`` over ``DeviceLoader``s, a temperature fit
    stored in ``best_model``'s sidecar, and ``load_engine``."""
    from rovit_kan_tpu_torch.evaluation import evaluator as ev_mod
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.utils import checkpoint as ck
    from rovit_kan_tpu_torch.utils.checkpoint import update_meta

    writes = []
    real_write, real_report = ck._write, ev_mod.fit_temperature_report
    ck._write = lambda stage, *a: (writes.append(stage.name),
                                   real_write(stage, *a))
    rank = 0 if mesh is None else mesh.rank
    if task["perturb_t"] and rank == 1:
        # This rank's own fit would give another T; the broadcast must win.
        ev_mod.fit_temperature_report = lambda *a: {
            **real_report(*a), "temperature": 9.0}
    try:
        return _fit(task, mesh, ev_mod, load_engine, update_meta) | {
            "writes": writes}
    finally:
        ck._write, ev_mod.fit_temperature_report = real_write, real_report


def _fit(task, mesh, ev_mod, load_engine, update_meta) -> dict:
    ckpt = Path(task["dir"]) / "checkpoints"
    cfg = _fit_config(ckpt)
    kw = dict(device="cpu", mesh=mesh, shard_data=task["sharded"])
    train = DeviceLoader(ArrayDS(40), 8, shuffle=True, drop_last=True,
                         seed=5, **kw)
    val = DeviceLoader(ArrayDS(13, seed=1), 8, **kw)
    model = build_model(cfg, device="cpu", seed=0)
    trainer = Trainer(model, train, val, cfg, focal_alpha=ALPHA, seed=0,
                      mesh=mesh)
    fit = trainer.fit()
    evaluator = ev_mod.Evaluator(model, trainer.eval_params(
        fit["best_state"]), val, cfg, output_dir=Path(task["dir"]) / "res")
    t = evaluator.fit_temperature(val)
    update_meta(ckpt / "best_model", temperature=t)
    engine = load_engine(ckpt / "best_model", device="cpu")
    images = ArrayDS(4, seed=2).images
    return {"val_loss": [h["total_loss"] for h in fit["history"]["val"]],
            "train_loss": [h["total_loss"] for h in fit["history"]["train"]],
            "val_acc": [h["accuracy"] for h in fit["history"]["val"]],
            "params": trainer.optimizer.flat.clone(),
            "temperature": t, "engine_temperature": engine.temperature,
            "served": engine.predict(images)["cls_probs"]}


def _worker(task_path: str) -> None:
    task = torch.load(task_path, weights_only=False)
    mesh = make_mesh(-1, device="cpu")
    out = (run_steps if task["kind"] == "steps" else run_fit)(task, mesh)
    torch.save(out, Path(task_path).parent / f"out{mesh.rank}.pt")


# -- plans --------------------------------------------------------------------

@pytest.mark.parametrize("n_proc,batch", [(1, 8), (2, 8), (4, 64), (8, 16),
                                          (3, 12)])
def test_local_batch_slice_matches_jax(n_proc, batch, monkeypatch):
    import jax
    from rovit_kan_tpu.parallel import multihost as jmh
    for rank in range(n_proc):
        monkeypatch.setattr(jax, "process_count", lambda: n_proc)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(multihost, "process_count", lambda: n_proc)
        monkeypatch.setattr(multihost, "process_index", lambda: rank)
        assert multihost.local_batch_slice(batch) == \
            jmh.local_batch_slice(batch)
        assert Mesh(n_proc, rank, torch.device("cpu"), "gloo").rows(
            batch) == jmh.local_batch_slice(batch)
    if n_proc > 1:
        with pytest.raises(ValueError, match="not divisible"):
            multihost.local_batch_slice(batch + 1)
        with pytest.raises(ValueError, match="not divisible"):
            jmh.local_batch_slice(batch + 1)


@pytest.mark.parametrize("n,batch,dp", [(37, 8, 2), (40, 8, 4), (13, 6, 3),
                                        (64, 16, 8), (9, 4, 2)])
def test_sharded_plans_and_shards_match_jax(n, batch, dp):
    from rovit_kan_tpu.data.device_cache import DeviceLoader as JaxLoader
    from rovit_kan_tpu.parallel.mesh import make_mesh as jax_make_mesh
    ds = ArrayDS(n, size=4)
    jmesh = jax_make_mesh(dp)
    for shuffle, drop_last in ((True, True), (False, False)):
        jl = JaxLoader(ds, batch, shuffle=shuffle, drop_last=drop_last,
                       seed=5, mesh=jmesh, shard_data=True)
        ports = [DeviceLoader(ds, batch, shuffle=shuffle,
                              drop_last=drop_last, seed=5, device="cpu",
                              mesh=Mesh(dp, r, torch.device("cpu"), "gloo"),
                              shard_data=True) for r in range(dp)]
        shards = [np.asarray(s.data) for s in sorted(
            jl._images.addressable_shards, key=lambda s: s.index[0].start)]
        for r, pl in enumerate(ports):
            assert pl.sharded and len(pl) == len(jl)
            np.testing.assert_array_equal(pl.arrays[0].numpy(), shards[r])
        for epoch in range(2):
            if drop_last:
                want = jl.epoch_index_plan()
                for pl in ports:
                    np.testing.assert_array_equal(pl.epoch_index_plan(),
                                                  want)
            else:
                want_idx, want_valid = jl.eval_index_plan()
                for pl in ports:
                    idx, valid = pl.eval_index_plan()
                    np.testing.assert_array_equal(idx, want_idx)
                    np.testing.assert_array_equal(valid, want_valid)


# -- one process against two ranks ------------------------------------------

def _batch(step: int, b: int = 8):
    rng = np.random.RandomState(100 + step)
    images = rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 4, b)
    return {"images": torch.from_numpy(images),
            "labels": torch.from_numpy(labels).long(),
            "severity": torch.from_numpy(labels.astype(np.float32))}


def test_two_ranks_equal_one_device(tmp_path):
    """Dropout 0.3, CutMix/MixUp and the fused augment (its plain version
    on the CPU) on; the ranks draw every random number for the global
    batch."""
    torch.manual_seed(0)
    task = {"kind": "steps", "model_kw": dict(KW, dropout=0.3),
            "state_dict": RoViTKAN(**KW, dropout=0.3).state_dict(),
            "fused_augment": True, "stages": [(4, 1.0), (4, 1.0)],
            "batches": [_batch(0), _batch(1)], "draws": None}
    single = run_steps(task, None)
    ranks = run_ranks(task, tmp_path)
    for got in ranks:
        np.testing.assert_allclose(got["losses"], single["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["accuracy"], single["accuracy"],
                                   atol=1e-6)
        np.testing.assert_allclose(got["params"][-1].numpy(),
                                   single["params"][-1].numpy(), atol=1e-6)
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        assert torch.equal(a, b)
    # The step moved the weights: the check above is not of a no-op.
    assert not torch.equal(ranks[0]["params"][0], ranks[0]["params"][1])


def test_two_ranks_match_jax_trainer_on_two_devices(tmp_path):
    import jax
    import jax.numpy as jnp
    from rovit_kan_tpu.config import Config as JaxConfig
    from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
    from rovit_kan_tpu.ops.augment_kernel import _draw_factors
    from rovit_kan_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from rovit_kan_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from rovit_kan_tpu.training.optimizer import \
        set_hyperparams as jax_set_hyperparams
    from rovit_kan_tpu.training.trainer import Trainer as JaxTrainer
    from rovit_kan_tpu_torch.models.convert import (
        load_jax_params,
        to_jax_params,
    )
    from test_torch_mixing import jax_draws
    from test_torch_train_step import _flat

    jcfg = JaxConfig()
    jcfg.flags.mixed_precision = False
    jcfg.data.image_size = 32
    jcfg.train.learning_rate = LR
    flags = dict(KW, dropout=0.0, use_pallas_block=False,
                 use_pallas_kan=False, use_pallas_attention=False)
    trainer = JaxTrainer(JaxRoViTKAN(**flags), None, None, jcfg,
                         focal_alpha=ALPHA, mesh=jax_make_mesh(2), seed=0)
    state = trainer.init_state()
    start = jax.tree.map(np.asarray, state.params)
    stages = [(2, 0.0), (4, 1.0)]
    batches, draws, jlosses = [], [], []
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
        state, m = trainer.train_step(state, jax_shard_batch(
            jb, trainer.mesh), jnp.int32(stage), jnp.float32(live),
            jnp.float32(1.0))
        jlosses.append(float(m["total_loss"]))
        batches.append(b)
    model = load_jax_params(RoViTKAN(**KW, dropout=0.0), start,
                            device="cpu")
    task = {"kind": "steps", "model_kw": dict(KW, dropout=0.0),
            "state_dict": model.state_dict(), "fused_augment": "auto",
            "stages": stages, "batches": batches, "draws": draws}
    ranks = run_ranks(task, tmp_path)
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    for got in ranks:
        np.testing.assert_allclose(got["losses"], jlosses, atol=1e-4,
                                   rtol=1e-4)
        model.load_state_dict(got["state_dict"])
        for k, v in dict(_flat(to_jax_params(model))).items():
            np.testing.assert_allclose(v, want[k], atol=2e-5,
                                       err_msg="/".join(k))


@pytest.mark.parametrize("sharded", [False, True])
def test_two_process_fit(sharded, tmp_path):
    """Over the replicated cache the two ranks' fit is the one-process fit;
    over the sharded one (stratified batches, another order) the ranks
    agree. Either way rank 0 alone writes and every rank serves rank 0's
    temperature."""
    task = {"kind": "fit", "sharded": sharded, "perturb_t": True,
            "dir": str(tmp_path)}
    ranks = run_ranks(task, tmp_path)
    r0, r1 = ranks
    assert r0["writes"] and not r1["writes"]
    assert r1["temperature"] == r0["temperature"] != 9.0
    assert r0["engine_temperature"] == r1["engine_temperature"] == \
        pytest.approx(r0["temperature"])
    assert torch.equal(r0["params"], r1["params"])
    assert r0["val_loss"] == r1["val_loss"]
    np.testing.assert_array_equal(r0["served"], r1["served"])
    assert np.isfinite(r0["served"]).all()
    if not sharded:
        single_dir = tmp_path / "single"
        single = run_fit(dict(task, dir=str(single_dir), perturb_t=False),
                         None)
        np.testing.assert_allclose(r0["train_loss"], single["train_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r0["val_loss"], single["val_loss"],
                                   rtol=1e-5)
        assert r0["val_acc"] == single["val_acc"]
        np.testing.assert_allclose(r0["params"].numpy(),
                                   single["params"].numpy(), atol=1e-5)


def _train_cli(tmp_path, *extra, data=None):
    data = data or tmp_path / "data"
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "rovit_kan_tpu_torch.cli.train",
           "--data_root", str(data), "--synthetic", "--fast", "--cpu",
           "--output_dir", str(out), *extra]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=TIMEOUT,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    return p, out


def test_cli_train_two_cpu_ranks(tmp_path):
    import csv

    from rovit_kan_tpu_torch.serving import load_engine
    p, out = _train_cli(tmp_path / "dp", "--devices", "2")
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert "rank 1 of 2 on cpu (gloo)" in p.stdout
    best = out / "checkpoints" / "best_model"
    rows = list(csv.DictReader(open(out / "logs" / "train_epochs.csv")))
    assert [r["epoch"] for r in rows] == ["1", "2"]     # one writer
    assert (out / "results" / "test_metrics.json").exists()
    engine = load_engine(best, device="cpu")
    probs = engine.predict(ArrayDS(3, size=64).images)["cls_probs"]
    assert np.isfinite(probs).all()

    one, out1 = _train_cli(tmp_path / "one", "--devices", "1")
    assert one.returncode == 0, one.stderr[-3000:]
    rows1 = list(csv.DictReader(open(out1 / "logs" / "train_epochs.csv")))
    for a, b in zip(rows, rows1):
        for k in ("train_total_loss", "val_total_loss",
                      "val_accuracy"):
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-4), k


def test_cli_run_ablation_two_cpu_ranks(tmp_path):
    """``cli.run_ablation --devices 2``: every variant trains on both ranks,
    rank 0 alone writes the epoch CSVs, metrics and the summary."""
    import csv
    out = tmp_path / "out"
    p = subprocess.run(
        [sys.executable, "-m", "rovit_kan_tpu_torch.cli.run_ablation",
         "--data-root", str(tmp_path / "data"), "--output-dir", str(out),
         "--synthetic", "--tiny", "--cpu", "--epochs", "1", "--devices",
         "2"], cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    rows = list(csv.DictReader(open(out / "ablation_results.csv")))
    assert len(rows) == 6
    for r in rows:
        epochs = list(csv.DictReader(open(
            out / r["experiment"] / f"{r['experiment']}_epochs.csv")))
        assert [e["epoch"] for e in epochs] == ["1"]        # one writer
        assert np.isfinite(float(r["accuracy"]))
    assert (out / "component_importance.json").exists()


# -- refusals -----------------------------------------------------------------

def test_refusals(monkeypatch, tmp_path):
    from rovit_kan_tpu_torch.cli import data_parallel_size
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="asks for 4 cards, but 1 are"):
        data_parallel_size(4, cpu=False)
    assert data_parallel_size(-1, cpu=False) == 1
    assert data_parallel_size(3, cpu=True) == 3
    # A mesh of 2 needs two processes.
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(2, device="cpu")
    # An indivisible batch.
    two = Mesh(2, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        two.rows(7)
    with pytest.raises(ValueError, match="divisible by the data axis"):
        DeviceLoader(ArrayDS(10), 7, device="cpu", mesh=two,
                     shard_data=True)
    # A sharded loader on another mesh than the trainer's.
    loader = DeviceLoader(ArrayDS(10), 4, shuffle=True, drop_last=True,
                          device="cpu", mesh=two, shard_data=True)
    model = RoViTKAN(**KW)
    trainer = Trainer(model, loader, None, _fit_config(tmp_path), seed=0)
    with pytest.raises(ValueError, match="must share one mesh"):
        trainer.train_epoch(trainer.init_state(), 1)


def test_cli_rank_failure_fails_the_run(tmp_path):
    """A batch the two ranks cannot split fails both; the launcher exits
    non-zero naming the rank."""
    p, _ = _train_cli(tmp_path, "--devices", "2", "--batch_size", "7")
    assert p.returncode != 0
    assert "exited with code" in p.stderr
    assert "not divisible by 2 processes" in p.stdout + p.stderr


def test_spawn_workers_logs_and_time_limit(tmp_path):
    """Each rank's output lands in its log with torchrun's variables set; a
    rank still running at the time limit fails the launch and is stopped."""
    from rovit_kan_tpu_torch.cli import spawn_workers
    show = ("import os; print(os.environ['RANK'], os.environ['WORLD_SIZE'], "
            "os.environ['LOCAL_RANK'])")
    spawn_workers([sys.executable, "-c", show], 2, log_dir=tmp_path,
                  timeout=TIMEOUT)
    for r in range(2):
        assert (tmp_path / f"rank{r}.log").read_text().split() == [
            str(r), "2", str(r)]
    hang = [sys.executable, "-c", "import time; time.sleep(120)"]
    with pytest.raises(SystemExit, match="still running after 1 s"):
        spawn_workers(hang, 2, log_dir=tmp_path, timeout=1)


def test_mesh_of_one_runs_no_collective(monkeypatch):
    """A mesh of 1 makes no process group and the step keeps its bits."""
    mesh = make_mesh(1, device="cpu")
    assert mesh.size == 1 and not torch.distributed.is_initialized()
    torch.manual_seed(0)
    task = {"kind": "steps", "model_kw": dict(KW, dropout=0.3),
            "state_dict": RoViTKAN(**KW, dropout=0.3).state_dict(),
            "fused_augment": True, "stages": [(4, 1.0), (3, 0.0)],
            "batches": [_batch(0), _batch(1)], "draws": None}
    want = run_steps(task, None)

    def refuse(*a, **k):
        raise AssertionError("a collective ran on a mesh of 1")
    for name in ("all_reduce", "all_gather", "broadcast", "barrier",
                 "broadcast_object_list", "all_gather_object"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    got = run_steps(task, mesh)
    assert got["losses"] == want["losses"]
    for a, b in zip(got["params"], want["params"]):
        assert torch.equal(a, b)
    assert pmesh.shard_batch({"x": torch.arange(4)}, mesh)["x"].numel() == 4


if __name__ == "__main__":
    _worker(sys.argv[1])
