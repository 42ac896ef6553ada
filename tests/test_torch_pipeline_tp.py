"""The 3-D ``("data", "pipe", "model")`` mesh: the GPipe pipeline whose
stages run Megatron-sharded blocks (``parallel/pipeline.py``,
``make_pipeline_mesh(data, pipe, model)``), against one process and the JAX
package's pipeline on ``make_pipeline_mesh(2, 2, model=2)``.

- the layouts: ``pipeline_param_specs(tp=True)`` against the JAX spec tree
  on the toy's and the flagship's trees; the mesh's axes, ranks, peers and
  errors against the JAX mesh; each rank's bytes against the JAX
  ``sharded_size`` under the combined specs (the flagship's 6,824,296 B a
  rank over pipe 2 x model 2); the iota test (each rank's shards of a tree
  whose every element is its flat index against the JAX ``shard_params``'
  addressable shards of the split tree);
- one eight-rank gloo launch, data 2 x pipe 2 x model 2, one torch thread
  a rank (``python tests/test_torch_pipeline_tp.py TASK``, the cases of
  ``test_torch_expert.py``), at the JAX toy (d = 32, depth 4, 2 heads,
  32 px, 2 microbatches) and a 3-head toy at d = 48 (t = 2 does not divide
  its heads: one head runs on both model ranks): the steps with dropout,
  CutMix/MixUp and the EMA, each update from one process's gradient,
  against one process (loss 1e-5 relative, each step's gradient 1e-4 of
  each leaf's largest, parameters and EMA 2e-6), the same with the JAX
  draws against the JAX ``Trainer`` on the 3-D mesh, which the main
  process runs meanwhile (losses 1e-4, parameters 2e-5); the forward against the JAX
  ``pipelined_forward`` and its gradient against ``jax.grad`` of it (1e-5
  of each leaf's largest), and both toys' against one process; the
  replicated leaves bit-equal on every rank, and their gradients on the
  four ranks of a data index; each rank's state bytes; a fit whose
  checkpoint is the one-process file, and a one-process checkpoint resumed
  on the 3-D mesh;
- ``cli.train --cpu --devices 8 --tensor_parallel 2 --pipeline_parallel 2
  --pipeline_microbatches 2`` beside ``--devices 1``.
"""
from __future__ import annotations

import copy
import sys
import time

import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.models.convert import _jax_path
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.parallel.fsdp import sharded_size
from rovit_kan_tpu_torch.parallel.mesh import Mesh
from rovit_kan_tpu_torch.parallel.pipeline import (
    Pipeline,
    pipeline_param_specs,
)
from test_torch_expert import (
    assert_cli,
    assert_fit,
    assert_jax_steps,
    assert_whole_gradient,
    cli_train,
    close_but_key_bias,
    jax_images,
    join,
    run_case,
    run_fit,
    run_jax_steps,
    save_for_ranks,
    start_ranks,
)
from test_torch_pipeline import TOY, _jax_toy, jax_forward_grads
from test_torch_tensor import STAGES, _batch, _jax_draws, _leaf

DATA, PIPE, MODEL = 2, 2, 2
RANKS = DATA * PIPE * MODEL
TOY3 = dict(embed_dim=48, depth=2, num_heads=3, image_size=32, patch_size=16,
            kan_layers=(48, 8, 1), hidden_dim=16)
#: The flagship's parameter bytes a rank over pipe 2 x model 2: a PP stage's
#: 12,148,840 less half of each of its six blocks' 443,712 Megatron-sharded
#: parameter bytes.
FLAGSHIP_3D_BYTES = 6_824_296


def mesh3(data: int = DATA, pipe: int = PIPE, model: int = MODEL,
          rank: int = 0) -> Mesh:
    """Global rank ``rank``'s view of a data x pipe x model mesh, without a
    process group (enough for the layouts, which run no collective)."""
    d, p, m = rank // (pipe * model), rank // model % pipe, rank % model
    return Mesh(data, d, torch.device("cpu"), "gloo", second_size=pipe,
                second_rank=p, third_size=model, third_rank=m,
                axis_names=("data", "pipe", "model"))


def _split_shapes(**kw):
    import jax

    from rovit_kan_tpu.parallel.pipeline import split_params as jax_split
    from test_torch_expert import _jax_shapes
    return jax_split(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                  _jax_shapes(**kw)))


# -- the layouts --------------------------------------------------------------

@pytest.mark.parametrize("which", ["toy", "flagship"])
def test_pipeline_specs_tp_match_jax(which):
    """``pipeline_param_specs(tp=True)`` against the JAX spec tree, leaf for
    leaf: every stacked block leaf on "pipe", and the four Megatron pairs'
    weights and column biases also on "model" (the stacked qkv kernel
    ``("pipe", None, "model")``, fc2's ``("pipe", "model", None)``)."""
    import jax

    from rovit_kan_tpu.parallel.pipeline import \
        pipeline_param_specs as jax_specs
    split = _split_shapes(**(TOY if which == "toy" else {}))
    want = jax_specs(split, tp=True)
    got = pipeline_param_specs(split, tp=True)
    pairs = list(zip(
        jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)),
        jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))))
    assert len(pairs) == len(jax.tree.leaves(split))
    for (path, spec), g in pairs:
        assert tuple(spec) == g, path
    blocks = got["backbone"]["blocks"]
    assert blocks["attn"]["qkv"]["kernel"] == ("pipe", None, "model")
    assert blocks["mlp"]["fc2"]["kernel"] == ("pipe", "model", None)
    assert blocks["mlp"]["fc2"]["bias"] == ("pipe",)
    assert sum("model" in g for _, g in pairs) == 6
    assert sum(g[:1] == ("pipe",) for _, g in pairs) == 12


def test_mesh_axes_ranks_and_errors_as_jax():
    """Rank (d, p, m) is device (d * 2 + p) * 2 + m of the JAX
    ``make_pipeline_mesh(2, 2, model=2)``; each rank's axis sizes, indices
    and peers; the JAX errors."""
    import jax

    from rovit_kan_tpu.parallel.pipeline import make_pipeline_mesh as jmake
    from rovit_kan_tpu_torch.parallel.mesh import make_pipeline_mesh
    jmesh = jmake(DATA, PIPE, model=MODEL)
    assert jmesh.axis_names == ("data", "pipe", "model")
    for r in range(RANKS):
        m = mesh3(rank=r)
        assert m.axis_names == jmesh.axis_names and m.world == RANKS
        assert m.global_rank == r
        coords = (m.rank, m.axis_rank("pipe"), m.axis_rank("model"))
        assert jmesh.devices[coords].id == r
        assert (m.size, m.axis_size("pipe"), m.axis_size("model"),
                m.model_size, m.inner_axes) == (2, 2, 2, 2, ("pipe", "model"))
        for axis, i in (("data", 0), ("pipe", 1), ("model", 0),
                        ("model", 1)):
            c = list(coords)
            c[m.axis_names.index(axis)] = i
            assert m.peer(axis, i) == jmesh.devices[tuple(c)].id
    assert repr(mesh3(rank=5)) == (
        "Mesh(size=2, rank=1, pipe_size=2, pipe_rank=0, model_size=2, "
        "model_rank=1, device=cpu, backend=gloo)")
    for args, msg in (((-1, 4, 2), "at least pipe\\*model = 8 devices"),
                      ((2, 2, 2), "need 8 devices, have 1"),
                      ((1, 1, 2), "need 2 devices, have 1")):
        with pytest.raises(ValueError, match=msg):
            make_pipeline_mesh(*args[:2], model=args[2], device="cpu")
        with pytest.raises(ValueError, match=msg):
            jmake(*args[:2], model=args[2], devices=jax.devices()[:1])


@pytest.mark.parametrize("which", ["toy", "flagship"])
def test_bytes_match_jax(which):
    """A rank's parameter bytes over pipe 2 x model 2 against the JAX
    ``sharded_size`` of the split tree under the combined specs: the
    flagship's 6,824,296."""
    from rovit_kan_tpu.parallel.fsdp import sharded_size as jax_size
    from rovit_kan_tpu.parallel.pipeline import make_pipeline_mesh as jmake
    from rovit_kan_tpu.parallel.pipeline import \
        pipeline_param_specs as jax_specs
    kw = TOY if which == "toy" else {}
    shapes = _split_shapes(**kw)
    want = jax_size(shapes, jax_specs(shapes, tp=True),
                    jmake(1, PIPE, model=MODEL))
    for r in range(PIPE * MODEL):
        pipe = Pipeline(RoViTKAN(**kw), mesh3(1, rank=r))
        got = sharded_size(pipe, {}, pipe.mesh, pipe.specs)
        assert got == want
        assert got == sum(v.numel() * 4 for v in pipe.state_dict().values())
    if which == "flagship":
        assert want == FLAGSHIP_3D_BYTES


def test_iota_shards_are_jax_addressable_shards():
    """Every element of the toy's tree is its flat index; rank (d, p, m)
    holds stage p's blocks cut on model index m and every whole leaf, as
    the JAX ``shard_params`` of the split tree puts them on device (d * 2 +
    p) * 2 + m of ``make_pipeline_mesh(2, 2, model=2)``, transposed to the
    port's layout."""
    import jax

    from rovit_kan_tpu.parallel.pipeline import make_pipeline_mesh as jmake
    from rovit_kan_tpu.parallel.pipeline import \
        pipeline_param_specs as jax_specs
    from rovit_kan_tpu.parallel.pipeline import split_params as jax_split
    from rovit_kan_tpu.parallel.tensor import shard_params as jax_shard
    from rovit_kan_tpu_torch.models.convert import load_jax_params
    params = _jax_toy()
    iota = jax.tree.map(lambda a: np.arange(a.size, dtype=np.float32)
                        .reshape(a.shape), params)
    split = jax_split(iota)
    placed = jax_shard(split, jmake(DATA, PIPE, model=MODEL),
                       jax_specs(split, tp=True))
    model = load_jax_params(RoViTKAN(**TOY), iota, device="cpu")
    per = TOY["depth"] // PIPE
    n_cut = 0
    for r in range(RANKS):
        pipe = Pipeline(copy.deepcopy(model), mesh3(rank=r))
        mine = pipe.state_dict()
        for name, p in model.named_parameters():
            path, transpose = _jax_path(name, p.dim())
            if name in pipe.block_leaves:
                if name not in mine:
                    continue
                i = int(name.split(".")[3])
                spath = ("backbone", "blocks") + tuple(path[2:])
                shard = sorted(_leaf(placed, spath).addressable_shards,
                               key=lambda s: s.device.id)[r]
                want = np.asarray(shard.data)[i % per]
                n_cut += name in pipe.tp_specs
            else:
                shard = sorted(_leaf(placed, path).addressable_shards,
                               key=lambda s: s.device.id)[r]
                want = np.asarray(shard.data)
            got = mine[name].numpy()
            np.testing.assert_array_equal(got.T if transpose else got, want,
                                          err_msg=f"{name} rank {r}")
    assert n_cut == RANKS * per * 6


def test_one_rank_checks_and_cut_state():
    """Without ranks: the sharded block needs its Megatron pairs to divide
    the model axis; a one-process state cut to rank (0, 1, 1) is its
    stage's blocks cut on model index 1, moments included; and the whole
    leaves on a pipeline rank are untouched."""
    from rovit_kan_tpu_torch.parallel.tensor import shard_state
    from rovit_kan_tpu_torch.training import optimizer as topt
    from rovit_kan_tpu_torch.training.trainer import TrainState
    from test_torch_tensor import _config
    with pytest.raises(ValueError, match="do not divide"):
        Pipeline(RoViTKAN(**TOY3), mesh3(1, 2, 5))
    model = RoViTKAN(**TOY)
    opt = topt.build_optimizer(model, _config())
    opt.grad.normal_(generator=torch.Generator().manual_seed(0))
    opt.step()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = TrainState(params, opt.state_dict(), dict(params), step=1)
    pipe = Pipeline(copy.deepcopy(model), mesh3(1, rank=3))
    cut = shard_state(state, pipe)
    qkv = "backbone.model.blocks.2.attn.qkv.weight"
    fc2 = "backbone.model.blocks.3.mlp.fc2.weight"
    assert "backbone.model.blocks.0.attn.qkv.weight" not in cut.params
    assert torch.equal(cut.params[qkv], params[qkv][48:])
    assert torch.equal(cut.params[fc2], params[fc2][:, 64:])
    assert torch.equal(cut.ema_params[fc2], params[fc2][:, 64:])
    names = cut.opt_state["names"]
    sizes = [cut.params[k].numel() for k in names]
    mu = dict(zip(names, torch.split(cut.opt_state["mu"], sizes)))
    whole = dict(zip(opt.names, torch.split(opt.mu, opt._sizes)))
    assert torch.equal(mu[qkv], whole[qkv].view(96, 32)[48:].reshape(-1))
    assert pipe.leaf_axes[qkv] == ("pipe", "model")
    assert pipe.leaf_axes["backbone.model.blocks.3.mlp.fc2.bias"] == ("pipe",)
    assert "backbone.model.norm.weight" not in pipe.leaf_axes


# -- the ranks ----------------------------------------------------------------

def _worker(task_path: str) -> None:
    from pathlib import Path

    from rovit_kan_tpu_torch.parallel.mesh import make_pipeline_mesh
    task = torch.load(task_path, weights_only=False)
    mesh = make_pipeline_mesh(DATA, PIPE, model=MODEL, device="cpu")
    out = {name: run_case(case, mesh) for name, case in task["ranks"].items()}
    torch.save(out, Path(task_path).parent / f"out{mesh.global_rank}.pt")


def _start(model_kw: dict, seed: int):
    from rovit_kan_tpu_torch.models.rovit_kan import init_weights
    start = RoViTKAN(**dict(model_kw, dropout=0.3))
    init_weights(start, seed)
    return start.state_dict()


def _jax_runs(ranks: dict, jax_params) -> dict:
    """The JAX ``Trainer`` on ``make_pipeline_mesh(2, 2, model=2)`` (its
    seconds kept), and the JAX ``pipelined_forward`` with ``jax.grad`` of
    it on the same mesh."""
    from rovit_kan_tpu.parallel.pipeline import make_pipeline_mesh as jmake
    jmesh = jmake(DATA, PIPE, model=MODEL)
    t0 = time.perf_counter()
    out = {"steps": run_jax_steps(ranks["jaxdraws"], jax_params, jmesh)}
    out["trainer_seconds"] = time.perf_counter() - t0
    out.update(jax_forward_grads(ranks["grads"]["x"], jax_params, jmesh))
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The one launch of eight ranks running every case, the two CLI runs
    beside it, and meanwhile the one-process runs and the JAX runs in this
    process."""
    from rovit_kan_tpu_torch.models.convert import to_jax_params
    tmp = tmp_path_factory.mktemp("pipeline_tp")
    batches = [_batch(i) for i in range(len(STAGES))]
    sd, sd3 = _start(TOY, 1), _start(TOY3, 2)
    model0 = RoViTKAN(**dict(TOY, dropout=0.0))
    model0.load_state_dict(sd)
    steps = {"axis": "pipe", "fused_augment": True, "ema_decay": 0.9,
             "draws": None, "batches": batches}
    ranks = {
        "steps": dict(steps, model_kw=dict(TOY, dropout=0.3), state_dict=sd,
                      taught=str(tmp / "steps_grads.pt")),
        "steps_h3": dict(steps, model_kw=dict(TOY3, dropout=0.3),
                         state_dict=sd3,
                         taught=str(tmp / "steps_h3_grads.pt")),
        "jaxdraws": {"model_kw": dict(TOY, dropout=0.0), "axis": "pipe",
                     "state_dict": sd, "fused_augment": "auto",
                     "draws": _jax_draws(len(STAGES)), "batches": batches},
        "grads": {"kind": "grads", "model_kw": dict(TOY, dropout=0.0),
                  "axis": "pipe", "state_dict": sd, "x": jax_images()},
        "grads_h3": {"kind": "grads", "model_kw": dict(TOY3, dropout=0.0),
                     "axis": "pipe", "state_dict": sd3, "x": jax_images()},
        "fit": {"kind": "fit", "axis": "pipe", "dir": str(tmp / "ranks"),
                "resume": str(tmp / "single" / "checkpoints")}}
    procs = start_ranks(__file__, {"ranks": ranks}, tmp, RANKS)
    flags = ["--tensor_parallel", "2", "--pipeline_parallel", "2",
             "--pipeline_microbatches", "2"]
    clis = [cli_train(tmp / "cli", "--devices", str(RANKS), *flags),
            cli_train(tmp / "cli1", "--devices", "1")]
    try:
        # The ranks' steps wait for these gradients; their fit resumes the
        # one-process checkpoint once "done" marks it.
        single = {}
        for k in ("steps", "steps_h3"):
            single[k] = run_case(ranks[k], None)
            save_for_ranks(single[k]["grads"], ranks[k]["taught"])
        single["fit"] = run_fit({"dir": str(tmp / "single"), "axis": "pipe"},
                                None)
        (tmp / "single" / "done").touch()
        for k in ("jaxdraws", "grads", "grads_h3"):
            single[k] = run_case(ranks[k], None)
        jax_out = _jax_runs(ranks, to_jax_params(model0))
        out = join(procs, tmp)
        cli = [(c.communicate(timeout=300)[0], c.returncode) for c in clis]
    finally:
        for p in procs + clis:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"single": single, "ranks": out, "jax": jax_out, "tmp": tmp,
            "start": sd, "cli": cli}


@pytest.mark.parametrize("case", ["steps", "steps_h3"])
def test_steps_equal_one_process(launched, case):
    """Dropout, CutMix/MixUp, the EMA and the fused augment's plain version
    on; stage 4, stage 2 frozen, stage 4, each update of the mesh from one
    process's gradient of that step (``run_steps``' ``taught``), so each
    step runs on one process's weights: every rank's losses (1e-5
    relative); each step's gradient, gathered whole on rank 0, within 1e-4
    of each leaf's largest magnitude of one process's (the baseline
    harness's first-step limit: one float32 process itself lies up to
    8.8e-6 of the leaf's largest from float64 on the 3-head toy's KAN
    linear weight, where the mesh lies 8.5e-6 from one process); rank 0's
    gathered parameters and EMA after the steps within 2e-6, each block's
    key bias as ``close_but_key_bias`` says.

    The mesh's own updates are not held here: the step clips the gradient
    by its global norm (152 on the 3-head toy), which puts many elements'
    clipped gradients within some tens of Adam's eps, where the first
    update ``g / (|g| + eps)`` turns a rounding-sized change of the
    gradient into a sizeable share of the learning rate. Any other
    summation order of the same sums lands elsewhere there: the mesh's
    first gradient and one process's lie as far from a float64 run of one
    process, yet free-running parameters parted by up to 4.7e-6 after the
    three steps (the 3-head toy's block-0 fc2 weight [25, 129], whose
    gradient is 7.67e-7 of the leaf's 1.98 in float64)."""
    single = launched["single"][case]
    for got in launched["ranks"]:
        np.testing.assert_allclose(got[case]["losses"], single["losses"],
                                   rtol=1e-5)
    got = launched["ranks"][0][case]
    assert len(got["grads"]) == len(single["grads"]) == len(STAGES)
    for i, (mesh, one) in enumerate(zip(got["grads"], single["grads"])):
        assert mesh.keys() == one.keys()
        for k, v in one.items():
            np.testing.assert_allclose(
                mesh[k].numpy(), v.numpy(), rtol=0,
                atol=1e-4 * max(float(v.abs().max()), 1e-30),
                err_msg=f"step {i} {k}")
    close_but_key_bias(got["params"], single["params"], 2e-6)
    close_but_key_bias(got["ema"], single["ema"], 2e-6)
    assert all(r[case]["params"] is None for r in launched["ranks"][1:])


def _rounding_level_first_gradient(sd) -> dict:
    """JAX path -> the elements whose one-process first-step gradient (the
    JAX draws, dropout off) is not zero but below 1e-6 of its leaf's
    largest magnitude: rounding sets its sign and size there."""
    from rovit_kan_tpu_torch.models.convert import to_jax_params
    from rovit_kan_tpu_torch.training import optimizer as topt
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    from test_torch_tensor import ALPHA, LR, _config
    from test_torch_train_step import _flat
    cfg = _config(fused_augment="auto")
    model = RoViTKAN(**dict(TOY, dropout=0.0))
    model.load_state_dict(sd)
    opt = topt.build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg, focal_alpha=ALPHA)
    stage, live = STAGES[0]
    topt.set_hyperparams(opt, LR, 0.1 * live)
    step(_batch(0), stage, live, 1, draws=_jax_draws(1)[0])
    grads = RoViTKAN(**dict(TOY, dropout=0.0))
    grads.load_state_dict({k: p.grad for k, p in model.named_parameters()})
    out = {}
    for k, g in _flat(to_jax_params(grads)):
        mask = (g != 0) & (np.abs(g) < 1e-6 * np.abs(g).max())
        if mask.any():
            out[k] = mask
    return out


def test_steps_match_jax_3d_trainer(launched):
    """The steps with the JAX draws against the JAX ``Trainer`` on
    ``make_pipeline_mesh(2, 2, model=2)`` (losses 1e-4, parameters 2e-5);
    an element whose first gradient is at rounding level within two of
    Adam's largest moves, as ``close_but_key_bias`` holds the key biases:
    Adam's first update is ``g / (|g| + eps)``, so such a gradient (the
    toy's block-1 fc1 weight holds one at 9.7e-9 of its leaf's 0.35) moves
    the element by a part of the learning rate that rounding sets. The JAX
    trainers on the data, pipeline and 3-D meshes part from each other
    there by 1.3e-5 to 1.7e-5 after these steps."""
    noisy = _rounding_level_first_gradient(launched["start"])
    # The key biases (their gradient is zero but for rounding) and a few
    # dozen elements more, of the toy's 79,538.
    n = sum(int(m.sum()) for m in noisy.values())
    assert n < 0.01 * sum(v.numel() for v in launched["start"].values())
    assert_jax_steps(dict(launched, kw=dict(TOY, dropout=0.0)), noisy)
    assert launched["jax"]["trainer_seconds"] > 0


def test_forward_and_gradient_match_jax_pipeline(launched):
    """Rank 0's outputs against the JAX ``pipelined_forward`` on the 3-D
    mesh (1e-5), its whole gradient, every leaf and the images', against
    ``jax.grad`` of it (1e-5 of each leaf's largest), and both toys'
    against one process: the JAX toy's at 1e-5, the 3-head toy's at 2e-5
    (its one-process gradient parts from the JAX package's ``jax.grad`` by
    up to 1.6e-5 of a leaf's largest, and the ranks' from one process by
    1.1e-5: fp32 summation order at this toy's conditioning)."""
    assert_whole_gradient(launched)
    h3 = {"single": {"grads": launched["single"]["grads_h3"]},
          "ranks": [{"grads": r["grads_h3"]} for r in launched["ranks"]]}
    assert_whole_gradient(h3, 2e-5)
    want = launched["jax"]
    got = launched["ranks"][0]["grads"]
    for k, v in want["forward"].items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-5, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(
        got["x_grad"].numpy(), want["x_grad"], rtol=0,
        atol=1e-5 * float(np.abs(want["x_grad"]).max()))
    for name, g in got["grads"].items():
        path, transpose = _jax_path(name, g.dim())
        w = _leaf(want["grads"], path)
        g = g.numpy().T if transpose else g.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(
            float(np.abs(w).max()), 1e-30), err_msg=name)


def test_replicated_leaves_equal_on_every_rank(launched):
    """The whole leaves after the steps on every rank, bit for bit, and
    their gradients on the four ranks of a data index (two stages, two
    model indices each)."""
    ranks = launched["ranks"]
    for case in ("steps", "steps_h3"):
        first = ranks[0][case]["replicated"]
        assert "backbone.model.patch_embed.proj.weight" in first
        for r in ranks[1:]:
            assert r[case]["replicated"].keys() == first.keys()
            for k, v in r[case]["replicated"].items():
                assert torch.equal(v, first[k]), (case, k)
    per = PIPE * MODEL
    for d in range(DATA):
        for case in ("grads", "grads_h3"):
            own = [ranks[d * per + x][case]["rank_grads"] for x in range(per)]
            whole = {k for k in own[0] if not k.startswith(
                "backbone.model.blocks.")}
            for g in own[1:]:
                for k in whole:
                    assert torch.equal(g[k], own[0][k]), (case, k)


def test_state_bytes_are_a_stage_cut_on_the_model_axis(launched):
    """Each rank's parameters, moments and EMA: its two blocks, their
    Megatron leaves halved, and the whole leaves: ``sharded_size``'s
    bytes."""
    model = RoViTKAN(**TOY)
    full = sum(v.numel() * 4 for v in model.parameters())
    blocks = sum(v.numel() * 4 for v in model.backbone.model.blocks
                 .parameters())
    cut = sum(v.numel() * 4 for k, v in model.backbone.model.blocks
              .named_parameters() if k.split(".", 1)[1] in (
                  "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
                  "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight"))
    for r in launched["ranks"]:
        want = r["steps"]["sharded_size"]
        assert r["steps"]["bytes"] == {"params": want, "mu": want,
                                       "nu": want, "ema": want}
        assert want == full - blocks // 2 - cut // 4


def test_fit_and_checkpoints(launched):
    assert_fit(launched, "Pipeline", "pipe")
    assert all(r["fit"]["n_micro"] == 2 for r in launched["ranks"])


def test_cli_train_3d_mesh(launched):
    assert_cli(launched, "Mesh: data=2 x pipe=2 x model=2 (pipeline + "
               "tensor parallel, 2 microbatches)", depth=2)


if __name__ == "__main__":
    _worker(sys.argv[1])
