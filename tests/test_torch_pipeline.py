"""The GPipe pipeline (``parallel/pipeline.py``) against one process and the
JAX package's pipeline on ``make_pipeline_mesh(2, 2)``.

- the layouts: ``split_params`` / ``merge_params`` against the JAX
  functions on the toy's tree (numpy and tensors), ``pipeline_param_specs``
  against the JAX specs, ``map_param_subtrees`` on an optax AdamW state;
  the per-rank bytes against the JAX ``sharded_size``; the iota test (each
  stage's blocks of a tree whose every element is its flat index against
  the JAX ``shard_params``' addressable shards of the stacked tree); the
  mesh's and the wrapper's errors;
- one four-rank gloo launch, data 2 x pipe 2 (``python
  tests/test_torch_pipeline.py TASK``, the cases of
  ``test_torch_expert.py``), at the JAX test's toy (d = 32, depth 4, 2
  heads, 32 px, 2 microbatches): the steps with dropout, CutMix/MixUp and
  the EMA against one process (loss 1e-5 relative, parameters and EMA
  2e-6; the heads' dropout draws one mask on every pipe rank), the same
  with the JAX draws against the JAX pipelined ``Trainer``, which the main
  process runs meanwhile (losses 1e-4, parameters 2e-5); the forward
  against the JAX ``pipelined_forward`` and its gradient, every leaf and
  the images', against ``jax.grad`` of it (1e-5 of each leaf's largest)
  and one process; the replicated leaves bit-equal on every rank; each
  rank's state bytes; a fit whose checkpoint is the one-process file, and
  a one-process checkpoint resumed pipelined;
- ``cli.train --cpu --devices 2 --pipeline_parallel 2
  --pipeline_microbatches 2`` beside ``--devices 1``.
"""
from __future__ import annotations

import copy
import sys

import numpy as np
import pytest
import torch

from rovit_kan_tpu_torch.models.convert import _jax_path
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN
from rovit_kan_tpu_torch.parallel.fsdp import sharded_size
from rovit_kan_tpu_torch.parallel.pipeline import (
    Pipeline,
    fit_microbatches,
    map_param_subtrees,
    merge_params,
    pipeline_param_specs,
    split_params,
)
from test_torch_expert import (
    DATA,
    LABELS,
    assert_cli,
    assert_fit,
    assert_jax_steps,
    assert_replicated,
    assert_whole_gradient,
    jax_images,
    launch,
    layout_mesh,
    run_jax_steps,
)
from test_torch_tensor import _leaf

PIPE = 2
TOY = dict(embed_dim=32, depth=4, num_heads=2, image_size=32, patch_size=16,
           kan_layers=(32, 8, 1), hidden_dim=16)


def _jax_toy():
    """The toy's seeded weights as the JAX package's tree (numpy)."""
    from rovit_kan_tpu_torch.models.convert import to_jax_params
    from rovit_kan_tpu_torch.models.rovit_kan import init_weights
    model = RoViTKAN(**TOY)
    init_weights(model, 0)
    return to_jax_params(model)


def _leaves(tree):
    import jax
    return jax.tree_util.tree_leaves_with_path(tree)


# -- the layouts --------------------------------------------------------------

def test_split_merge_round_trip_as_jax():
    import jax

    from rovit_kan_tpu.parallel.pipeline import merge_params as jax_merge
    from rovit_kan_tpu.parallel.pipeline import split_params as jax_split
    params = _jax_toy()
    want = jax_split(params)
    got = split_params(params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    assert np.asarray(want["backbone"]["blocks"]["norm1"]["scale"]) \
        .shape == (4, 32)
    back, jback = merge_params(got), jax_merge(want)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b, c in zip(jax.tree.leaves(back), jax.tree.leaves(jback),
                       jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, c)
    # The same on tensors.
    tparams = jax.tree.map(torch.from_numpy, params)
    for a, b in zip(jax.tree.leaves(split_params(tparams)),
                    jax.tree.leaves(want)):
        assert torch.is_tensor(a)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pipeline_specs_and_subtree_map_as_jax():
    """``pipeline_param_specs`` against the JAX spec tree, leaf for leaf,
    with and without ``tp=True`` (the 3-D mesh's Megatron rule on each
    stacked block leaf); ``map_param_subtrees`` splits an optax AdamW
    state's moments as the JAX function does."""
    import jax
    import optax

    from rovit_kan_tpu.parallel.pipeline import \
        map_param_subtrees as jax_map
    from rovit_kan_tpu.parallel.pipeline import \
        pipeline_param_specs as jax_specs
    from rovit_kan_tpu.parallel.pipeline import split_params as jax_split
    params = _jax_toy()
    split = split_params(params)
    want = jax_specs(jax_split(params))
    got = pipeline_param_specs(split)
    n_pipe = 0
    for (path, spec), g in zip(
            jax.tree_util.tree_leaves_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)),
            jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))):
        assert tuple(spec) == g, path
        n_pipe += g == ("pipe",)
    assert n_pipe == 12
    want = jax_specs(jax_split(params), tp=True)
    got = pipeline_param_specs(split, tp=True)
    n_model = 0
    for (path, spec), g in zip(
            jax.tree_util.tree_leaves_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)),
            jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))):
        assert tuple(spec) == g, path
        n_model += "model" in g
    assert n_model == 6
    state = jax.tree.map(np.asarray, optax.adamw(1e-3).init(params))
    got = map_param_subtrees(state, params, split_params)
    want = jax_map(state, params, jax_split)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_iota_shards_are_jax_addressable_shards():
    """Every element of the toy's tree is its flat index; rank (d, p) holds
    stage p's blocks, stacked, as the JAX ``shard_params`` of the split
    tree puts them on device d * 2 + p of ``make_pipeline_mesh(2, 2)``, and
    every whole leaf."""
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
    placed = jax_shard(split, jmake(DATA, PIPE), jax_specs(split))
    model = load_jax_params(RoViTKAN(**TOY), iota, device="cpu")
    for r in range(DATA * PIPE):
        pipe = Pipeline(copy.deepcopy(model),
                        layout_mesh(DATA, PIPE, r // PIPE, r % PIPE,
                                    axis="pipe"))
        mine = pipe.state_dict()
        assert set(mine) == set(pipe.stage_names(r % PIPE)) | {
            k for k in pipe.full_shapes if k not in pipe.block_leaves}
        for name, p in model.named_parameters():
            path, transpose = _jax_path(name, p.dim())
            if name in pipe.block_leaves:
                i = int(name.split(".")[3])
                if name not in mine:
                    continue
                spath = ("backbone", "blocks") + tuple(path[2:])
                shard = sorted(_leaf(placed, spath).addressable_shards,
                               key=lambda s: s.device.id)[r]
                got = mine[name].numpy()
                np.testing.assert_array_equal(
                    got.T if transpose else got,
                    np.asarray(shard.data)[i % (4 // PIPE)], err_msg=name)
            else:
                shard = sorted(_leaf(placed, path).addressable_shards,
                               key=lambda s: s.device.id)[r]
                got = mine[name].numpy()
                np.testing.assert_array_equal(
                    got.T if transpose else got, np.asarray(shard.data),
                    err_msg=name)


def test_bytes_match_jax():
    """A stage's parameter bytes, the toy's and the flagship's over a pipe
    axis of 2, against the JAX ``sharded_size`` of the split tree."""
    import jax

    from rovit_kan_tpu.parallel.fsdp import sharded_size as jax_size
    from rovit_kan_tpu.parallel.pipeline import make_pipeline_mesh as jmake
    from rovit_kan_tpu.parallel.pipeline import \
        pipeline_param_specs as jax_specs
    from rovit_kan_tpu.parallel.pipeline import split_params as jax_split
    from test_torch_expert import _jax_shapes
    jmesh = jmake(1, PIPE)
    for kw in (TOY, {}):
        shapes = jax_split(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), _jax_shapes(**kw)))
        pipe = Pipeline(RoViTKAN(**kw), layout_mesh(1, PIPE, axis="pipe"))
        got = sharded_size(pipe, {}, pipe.mesh, pipe.specs)
        assert got == jax_size(shapes, jax_specs(shapes), jmesh)
        assert got == sum(v.numel() * 4 for v in pipe.state_dict().values())


def test_meshes_and_refusals_as_jax():
    from rovit_kan_tpu_torch.parallel.mesh import make_pipeline_mesh
    with pytest.raises(ValueError, match="at least pipe\\*model = 4 "
                       "devices"):
        make_pipeline_mesh(-1, 4, device="cpu")
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_pipeline_mesh(2, 2, device="cpu")
    # The 3-D mesh's errors are the JAX ones too; its layouts and ranks are
    # tests/test_torch_pipeline_tp.py's.
    import jax

    from rovit_kan_tpu.parallel.pipeline import make_pipeline_mesh as jmake
    for model in (2, 3):
        msg = f"need {model} devices, have 1"
        with pytest.raises(ValueError, match=msg):
            make_pipeline_mesh(1, 1, model=model, device="cpu")
        with pytest.raises(ValueError, match=msg):
            jmake(1, 1, model=model, devices=jax.devices()[:1])
    one = make_pipeline_mesh(1, 1, device="cpu")
    assert one.axis_names == ("data", "pipe") and one.world == 1
    with pytest.raises(ValueError, match="'pipe' axis"):
        Pipeline(RoViTKAN(**TOY), layout_mesh(1, 2, axis="model"))
    with pytest.raises(ValueError, match="depth 4 not divisible by pipe=3"):
        Pipeline(RoViTKAN(**TOY), layout_mesh(1, 3, axis="pipe"))
    with pytest.raises(ValueError, match="MoE blocks do not compose"):
        Pipeline(RoViTKAN(**dict(TOY, moe_experts=4)),
                 layout_mesh(1, 2, axis="pipe"))
    assert [fit_microbatches(4, b) for b in (8, 6, 5, 1)] == [4, 3, 1, 1]
    # One stage: the schedule over 2 microbatches, the model's bits.
    torch.manual_seed(0)
    model = RoViTKAN(**TOY, dropout=0.0)
    x = torch.from_numpy(jax_images())
    want = model(x)["cls_logits"]
    pipe = Pipeline(copy.deepcopy(model), one, 2)
    assert torch.equal(pipe(x)["cls_logits"], want)
    with pytest.raises(ValueError, match="local batch 7 not divisible"):
        pipe(x[:7])
    with pytest.raises(NotImplementedError, match="under the pipeline"):
        pipe.model(x, return_attention=True)
    with pipe.full_module() as whole:
        assert torch.equal(whole(x)["cls_logits"], want)


def test_ablation_evaluates_the_model_whole(tmp_path, monkeypatch):
    """``AblationExperiment`` on a pipeline mesh (one stage, no process
    group) evaluates the selected weights on the model whole, as the JAX
    harness evaluates ``merge_params`` of them: the ``Evaluator`` gets the
    unpipelined module with the trainer's best weights in it."""
    from rovit_kan_tpu_torch.data.dataset import Loader
    from rovit_kan_tpu_torch.experiments import ablation
    from rovit_kan_tpu_torch.parallel.mesh import make_pipeline_mesh
    from test_torch_ablation import _tiny_cfg
    from test_torch_parallel import ArrayDS
    seen = {}
    real = ablation.Evaluator

    class Capturing(real):
        def __init__(self, model, params, *a, **kw):
            seen["pipe"] = model.backbone.model.pipe
            seen["params"] = params
            seen["weights"] = {k: v.clone()
                               for k, v in model.state_dict().items()}
            super().__init__(model, params, *a, **kw)

    monkeypatch.setattr(ablation, "Evaluator", Capturing)
    cfg = _tiny_cfg(tmp_path)
    cfg.model.depth, cfg.tpu.pipeline_microbatches = 2, 2
    data = ArrayDS(16)
    exp = ablation.AblationExperiment(
        cfg, Loader(data, 8, shuffle=True, drop_last=True),
        Loader(ArrayDS(8, seed=1), 8), Loader(ArrayDS(8, seed=2), 8),
        tmp_path / "out", variants=[ablation.AblationConfig("full_model")],
        device="cpu", run_fps=False,
        mesh=make_pipeline_mesh(1, 1, device="cpu"))
    m = exp.run_single_experiment(exp.variants[0], epochs=1)
    assert np.isfinite(m["accuracy"])
    assert seen["pipe"] is None and seen["params"] is None
    from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
    ck = load_checkpoint(tmp_path / "out" / "full_model" / "best_model")
    for k, v in ck["params"].items():
        assert torch.equal(seen["weights"][k], v), k


# -- the ranks ----------------------------------------------------------------

def jax_forward_grads(x: np.ndarray, jax_params, jmesh) -> dict:
    """The JAX ``pipelined_forward`` and ``jax.grad`` of the JAX pipeline
    test's loss on it (2 microbatches of the local batch) on ``jmesh``."""
    import jax
    import jax.numpy as jnp
    import optax

    from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
    from rovit_kan_tpu.parallel.pipeline import merge_params as jax_merge
    from rovit_kan_tpu.parallel.pipeline import \
        pipelined_forward as jax_forward
    from rovit_kan_tpu.parallel.pipeline import split_params as jax_split
    model = JaxRoViTKAN(**TOY, dropout=0.0, use_pallas_block=False,
                        use_pallas_kan=False, use_pallas_attention=False)
    labels = jnp.asarray(LABELS)

    def loss(split, x):
        # remat only reorders the backward's work: the same values.
        o = jax_forward(model, split, x, jmesh, n_micro=2, remat=False)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            o["cls_logits"], labels)
        return jnp.mean(ce) + jnp.mean(o["kan_severity"]), o

    (_, fwd), (g, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax_split(jax_params), jnp.asarray(x))
    return {"forward": jax.tree.map(np.asarray, fwd),
            "grads": jax.tree.map(np.asarray, jax_merge(g)),
            "x_grad": np.asarray(gx)}


def _jax_runs(ranks: dict, jax_params) -> dict:
    """The JAX pipelined ``Trainer`` on ``make_pipeline_mesh(2, 2)``, and
    ``jax_forward_grads`` on it."""
    from rovit_kan_tpu.parallel.pipeline import make_pipeline_mesh as jmake
    jmesh = jmake(DATA, PIPE)
    out = {"steps": run_jax_steps(ranks["jaxdraws"], jax_params, jmesh)}
    out.update(jax_forward_grads(ranks["grads"]["x"], jax_params, jmesh))
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    return launch(__file__, "pipe", TOY, tmp,
                  ["--pipeline_parallel", "2", "--pipeline_microbatches",
                   "2"], _jax_runs)


def test_steps_equal_one_process(launched):
    """Dropout, CutMix/MixUp, the EMA and the fused augment's plain version
    on; stage 4, stage 2 frozen, stage 4: every rank's losses, and rank 0's
    gathered parameters and EMA, against one process."""
    from test_torch_tensor import _close
    single = launched["single"]["steps"]
    for got in launched["ranks"]:
        np.testing.assert_allclose(got["steps"]["losses"], single["losses"],
                                   rtol=1e-5)
    got = launched["ranks"][0]["steps"]
    _close(got["params"], single["params"], 2e-6)
    _close(got["ema"], single["ema"], 2e-6)
    assert all(r["steps"]["params"] is None for r in launched["ranks"][1:])
    for i in (0, 3):
        qkv = f"backbone.model.blocks.{i}.attn.qkv.weight"
        assert not torch.equal(got["params"][qkv], launched["start"][qkv])


def test_steps_match_jax_pipelined_trainer(launched):
    assert_jax_steps(dict(launched, kw=dict(TOY, dropout=0.0)))


def test_forward_and_gradient_match_jax_pipeline(launched):
    """Rank 0's outputs against the JAX ``pipelined_forward`` (1e-5), its
    whole gradient, every leaf and the images', against ``jax.grad`` of
    the JAX pipeline (1e-5 of each leaf's largest), and both against one
    process."""
    assert_whole_gradient(launched)
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
    """The whole leaves after the steps on every rank, and their gradients
    on the two stages of a data index, bit for bit: the embedding's comes
    from stage 0's input gradient, which every pipe rank receives (a copy
    without that share fails here)."""
    assert_replicated(launched, "pipe")


def test_state_bytes_are_a_stage(launched):
    """Each rank's parameters, moments and EMA: its two blocks and the
    whole leaves, ``sharded_size``'s bytes."""
    model = RoViTKAN(**TOY)
    full = sum(v.numel() * 4 for v in model.parameters())
    blocks = sum(v.numel() * 4 for v in model.backbone.model.blocks
                 .parameters())
    for r in launched["ranks"]:
        want = r["steps"]["sharded_size"]
        assert r["steps"]["bytes"] == {"params": want, "mu": want,
                                       "nu": want, "ema": want}
        assert want == full - blocks // 2


def test_fit_and_checkpoints(launched):
    assert_fit(launched, "Pipeline", "pipe")
    assert all(r["fit"]["n_micro"] == 2 for r in launched["ranks"])


def test_cli_train_pipeline_parallel(launched):
    assert_cli(launched, "Mesh: data=1 x pipe=2 (pipeline parallel, 2 "
               "microbatches)", depth=2)


if __name__ == "__main__":
    from test_torch_expert import _worker
    _worker(sys.argv[1])
