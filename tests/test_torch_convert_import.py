"""The port's weight import against the JAX package's converter.

Reference-format and timm-format state_dicts are drawn from seeded numpy at
the reference's key names and shapes (a small model: d = 32, 2 blocks, 2
heads, KAN (32, 8, 1); the patch embedding a ``(D, 3, p, p)`` convolution)
and saved as ``.pth``. On the same file, the port's
``load_torch_checkpoint``, ``convert_timm_vit`` (extra timm keys ignored),
``convert_reference_checkpoint`` (the full model and each ablation variant)
and ``convert_checkpoint_file`` give the JAX functions' trees exactly; an
``.npz`` written by either package's ``save_npz`` loads with the other's
``load_npz``;
``cli.convert_checkpoint`` writes the ``.npz`` of
``scripts/convert_checkpoint.py`` (run in-process with its argv patched)
and prints its line; ``merge_pretrained`` gives the JAX tree and messages
(unknown keys skipped, a leaf of another shape kept at its init), the
``pos_embed`` resampled from 17 tokens up to 37 and down to 10 and 2 within
1e-6 (the port's interpolation tolerance, ``tests/test_torch_attention.py``).
``cli.train --fast --cpu --pretrained_npz`` starts from exactly the merged
weights, and ``--resume`` wins over them. A JAX checkpoint's weights reach
the port through the JAX package's ``save_npz`` bit for bit.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rovit_kan_tpu.models import convert as jconvert
from rovit_kan_tpu_torch.cli import convert_checkpoint as cli_convert
from rovit_kan_tpu_torch.cli import train as cli_train
from rovit_kan_tpu_torch.models import convert as tconvert
from rovit_kan_tpu_torch.models.rovit_kan import RoViTKAN, build_model
from rovit_kan_tpu_torch.training import trainer as trainer_mod
from rovit_kan_tpu_torch.utils.checkpoint import _to_reference, load_checkpoint

ROOT = Path(__file__).resolve().parent.parent
KW = dict(embed_dim=32, depth=2, num_heads=2, image_size=32, patch_size=16,
          kan_layers=(32, 8, 1), hidden_dim=16)
VARIANTS = {"full": {}, "no_ordinal": {"with_ordinal": False},
            "no_uncertainty": {"with_uncertainty": False},
            "no_kan": {"with_kan": False},
            "classifier_only": {"with_ordinal": False,
                                "with_uncertainty": False,
                                "with_kan": False}}
BACKBONE = "backbone.model."


def reference_sd(seed=0, **kw):
    """A reference ``model_state_dict``: the reference's names and shapes
    (the port's state_dict in the reference layout), seeded numpy values."""
    shapes = _to_reference(RoViTKAN(**dict(KW, **kw)).state_dict())
    rng = np.random.RandomState(seed)
    return {k: rng.normal(0, 0.05, tuple(v.shape)).astype(np.float32)
            for k, v in shapes.items()}


def timm_sd(seed=1, **kw):
    """A timm ViT state_dict: the backbone's keys without the wrapper's
    prefix, plus timm's classifier and ``fc_norm``, which the converter
    ignores."""
    rng = np.random.RandomState(seed + 100)
    sd = {k[len(BACKBONE):]: v for k, v in reference_sd(seed, **kw).items()
          if k.startswith(BACKBONE)}
    sd["head.weight"] = rng.normal(0, 0.05, (1000, 32)).astype(np.float32)
    sd["head.bias"] = np.zeros(1000, np.float32)
    sd["fc_norm.weight"] = np.ones(32, np.float32)
    sd["fc_norm.bias"] = np.zeros(32, np.float32)
    return sd


def save_pth(sd, path, wrap=True):
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save({"model_state_dict": tensors, "epoch": 3} if wrap
               else tensors, path)
    return path


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def assert_trees_equal(got, want, pos_atol=0.0):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert isinstance(g, np.ndarray) and g.dtype == np.float32, k
        assert g.shape == np.shape(w), k
        if pos_atol and k[-1] == "pos_embed":
            np.testing.assert_allclose(g, w, rtol=0, atol=pos_atol,
                                       err_msg="/".join(k))
        else:
            np.testing.assert_array_equal(g, w, err_msg="/".join(k))


@pytest.mark.parametrize("kind", ["reference", "timm"])
def test_load_torch_checkpoint_matches_jax(tmp_path, kind):
    sd = reference_sd() if kind == "reference" else timm_sd()
    path = save_pth(sd, tmp_path / "w.pth", wrap=kind == "reference")
    got = tconvert.load_torch_checkpoint(path)
    want = jconvert.load_torch_checkpoint(path)
    assert list(got) == list(want) == list(sd)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_convert_reference_checkpoint_matches_jax(variant):
    sd = reference_sd(**VARIANTS[variant])
    got = tconvert.convert_reference_checkpoint(sd, depth=2)
    assert_trees_equal(got, jconvert.convert_reference_checkpoint(sd,
                                                                  depth=2))
    heads = {"ordinal_head": "with_ordinal",
             "uncertainty_head": "with_uncertainty",
             "kan_module": "with_kan"}
    for head, toggle in heads.items():
        assert (head in got) == VARIANTS[variant].get(toggle, True)
    # The tree loads into the variant's model as it is.
    model = RoViTKAN(**dict(KW, **VARIANTS[variant]))
    tconvert.load_jax_params(model, got, device="cpu")


def test_convert_timm_vit_matches_jax():
    sd = timm_sd()
    got = tconvert.convert_timm_vit(sd, depth=2)
    assert_trees_equal(got, jconvert.convert_timm_vit(sd, depth=2))
    assert "head" not in got and "fc_norm" not in got
    # The (D, 3, p, p) convolution is the (p * p * 3, D) kernel.
    conv = sd["patch_embed.proj.weight"]
    np.testing.assert_array_equal(
        got["patch_embed"]["proj"]["kernel"],
        conv.transpose(2, 3, 1, 0).reshape(16 * 16 * 3, 32))


def test_npz_crosses_between_packages(tmp_path):
    tree = tconvert.convert_reference_checkpoint(reference_sd(), depth=2)
    tconvert.save_npz(tree, tmp_path / "port.npz")
    assert_trees_equal(jconvert.load_npz(tmp_path / "port.npz"), tree)
    jconvert.save_npz(tree, tmp_path / "jax.npz")
    assert_trees_equal(tconvert.load_npz(tmp_path / "jax.npz"), tree)
    assert_trees_equal(tconvert.load_npz(tmp_path / "port.npz"), tree)


def test_convert_checkpoint_file_matches_jax(tmp_path):
    src = save_pth(reference_sd(seed=4), tmp_path / "best_model.pth")
    got = tconvert.convert_checkpoint_file(src, tmp_path / "port.npz",
                                           depth=2)
    want = jconvert.convert_checkpoint_file(src, tmp_path / "jax.npz",
                                            depth=2)
    assert_trees_equal(got, want)
    assert_trees_equal(tconvert.load_npz(tmp_path / "port.npz"),
                       jconvert.load_npz(tmp_path / "jax.npz"))
    assert_trees_equal(tconvert.convert_checkpoint_file(src, depth=2), want)


def test_jax_checkpoint_weights_cross_through_npz(tmp_path):
    """The recipe that moves a JAX checkpoint's weights to the port: the
    JAX package's ``save_npz(load_checkpoint(path)["params"], f)``, then the
    port's ``load_npz`` and ``load_jax_params``, bit for bit."""
    import jax
    from rovit_kan_tpu.config import get_config
    from rovit_kan_tpu.models.rovit_kan import RoViTKAN as JaxRoViTKAN
    from rovit_kan_tpu.utils import checkpoint as jck
    params = jax.jit(JaxRoViTKAN(**KW).init)(
        jax.random.PRNGKey(3), np.zeros((1, 32, 32, 3), np.float32))["params"]
    jck.save_checkpoint(tmp_path / "best_model", params, config=get_config(),
                        epoch=1)
    jconvert.save_npz(jck.load_checkpoint(tmp_path / "best_model")["params"],
                      tmp_path / "w.npz")
    model = tconvert.load_jax_params(RoViTKAN(**KW),
                                     tconvert.load_npz(tmp_path / "w.npz"),
                                     device="cpu")
    assert_trees_equal(tconvert.to_jax_params(model),
                       jax.tree.map(np.asarray, params))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_checkpoint", ROOT / "scripts" / "convert_checkpoint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind", ["reference", "timm"])
def test_cli_writes_the_jax_scripts_npz(tmp_path, monkeypatch, capsys, kind):
    sd = reference_sd() if kind == "reference" else timm_sd()
    src = save_pth(sd, tmp_path / "w.pth", wrap=kind == "reference")
    outs = {}
    for name in ("port", "jax"):
        out = tmp_path / f"{name}.npz"
        argv = ["--input", str(src), "--output", str(out), "--depth", "2"]
        if name == "port":
            cli_convert.main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py"] + argv)
            _jax_script().main()
        outs[name] = (out, capsys.readouterr().out)
    (port, port_said), (jax_npz, jax_said) = outs["port"], outs["jax"]
    with np.load(port) as a, np.load(jax_npz) as b:
        assert a.files == b.files
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert port_said.replace(str(port), "OUT") == jax_said.replace(
        str(jax_npz), "OUT")
    assert port_said.startswith(
        "Converted reference RoViTKAN" if kind == "reference"
        else "Converted timm ViT backbone")


def _init_tree(image_size, num_classes=4):
    model = RoViTKAN(**dict(KW, image_size=image_size,
                            num_classes=num_classes))
    from rovit_kan_tpu_torch.models.rovit_kan import init_weights
    init_weights(model, seed=5)
    return tconvert.to_jax_params(model)


@pytest.mark.parametrize("image_size", [64, 96, 48, 16],
                         ids=["same_grid", "17to37", "17to10", "17to2"])
def test_merge_pretrained_matches_jax(capsys, image_size):
    """The pretrained tree (64 px: 17 tokens) carries an unknown leaf and
    an unknown head, and a classifier for 5 classes where the init has 4."""
    pre = tconvert.convert_reference_checkpoint(
        reference_sd(image_size=64, num_classes=5), depth=2)
    pre["backbone"]["dist_token"] = np.zeros((1, 1, 32), np.float32)
    pre["distill_head"] = {"kernel": np.zeros((32, 4), np.float32)}
    init = _init_tree(image_size)
    snapshot = dict(_flat(init))
    got = tconvert.merge_pretrained(init, pre)
    port_said = capsys.readouterr().out
    want = jconvert.merge_pretrained(init, pre)
    assert capsys.readouterr().out == port_said
    assert_trees_equal(got, want, pos_atol=1e-6)
    for k, v in snapshot.items():                  # the init is untouched
        assert dict(_flat(init))[k] is v
    assert "skipping unknown backbone/dist_token" in port_said
    assert "skipping unknown distill_head" in port_said
    fc2 = got["classification_head"]["fc2"]
    np.testing.assert_array_equal(fc2["kernel"],
                                  init["classification_head"]["fc2"]
                                  ["kernel"])
    assert "shape mismatch classification_head/fc2/kernel" in port_said
    np.testing.assert_array_equal(
        got["backbone"]["blocks_1"]["mlp"]["fc1"]["kernel"],
        pre["backbone"]["blocks_1"]["mlp"]["fc1"]["kernel"])
    grid = (image_size // 16) ** 2 + 1
    assert got["backbone"]["pos_embed"].shape == (1, grid, 32)
    assert ("interpolated backbone/pos_embed" in port_said) == (grid != 17)


@pytest.fixture(scope="module")
def pretrained_npz(tmp_path_factory):
    """Converted reference weights at 32 px (5 tokens) for the ``--fast``
    model (64 px, 17 tokens): the merge resamples the position embedding."""
    tmp = tmp_path_factory.mktemp("pretrained")
    src = save_pth(reference_sd(seed=9), tmp / "best_model.pth")
    cli_convert.main(["--input", str(src), "--output", str(tmp / "w.npz"),
                      "--depth", "2"])
    return tmp / "w.npz"


def _record_init_state(monkeypatch):
    """Wrap ``Trainer.init_state`` to keep a copy of the weights each call
    starts training from."""
    seen = []
    init_state = trainer_mod.Trainer.init_state

    def wrapped(self, params=None):
        state = init_state(self, params)
        seen.append({k: v.detach().clone() for k, v in state.params.items()})
        return state

    monkeypatch.setattr(trainer_mod.Trainer, "init_state", wrapped)
    return seen


def test_train_starts_from_the_merged_weights(tmp_path, monkeypatch, capsys,
                                              pretrained_npz):
    seen = _record_init_state(monkeypatch)
    argv = ["--data_root", str(tmp_path / "data"), "--output_dir",
            str(tmp_path / "out"), "--synthetic", "--fast", "--cpu",
            "--epochs", "1", "--pretrained_npz", str(pretrained_npz)]
    cli_train.main(argv)
    said = capsys.readouterr().out
    assert f"Loading pretrained weights: {pretrained_npz}" in said
    assert "interpolated backbone/pos_embed (1, 5, 32) -> (1, 17, 32)" in said
    assert len(seen) == 1
    args = cli_train.parse_args(argv)
    cfg = cli_train.build_config(args)
    assert cfg.model.pretrained_npz == pretrained_npz
    model = build_model(cfg, device="cpu", seed=args.seed)
    init = tconvert.to_jax_params(model)
    pre = tconvert.load_npz(pretrained_npz)
    want = tconvert.jax_state_dict(model, tconvert.merge_pretrained(
        init, pre, verbose=False))
    assert seen[0].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(seen[0][k], v), k
    # The JAX merge over the same init gives the same weights.
    jwant = tconvert.jax_state_dict(model, jconvert.merge_pretrained(
        init, pre, verbose=False))
    for k, v in jwant.items():
        torch.testing.assert_close(seen[0][k], v, rtol=0,
                                   atol=1e-6 if k.endswith("pos_embed")
                                   else 0)

    # --resume wins over --pretrained_npz: the run restarts from the
    # checkpoint the first run wrote.
    best = tmp_path / "out" / "checkpoints" / "best_model"
    restored = load_checkpoint(best)["params"]
    cli_train.main(argv + ["--resume"])
    said = capsys.readouterr().out
    assert "Resumed from epoch 1 (best_model)" in said
    assert "Loading pretrained weights" not in said
    assert len(seen) == 2
    for k, v in restored.items():
        assert torch.equal(seen[1][k], v.float()), k
