"""Config tree for the PyTorch/CUDA port.

A copy of ``rovit_kan_tpu/config.py`` (standard library only) with the same
sections and field names, so a config dict saved by the JAX package loads
here unchanged through ``Config.from_dict``. The port keeps its own copy
rather than importing the JAX package. The ``tpu`` section keeps its name;
in the port ``tpu.use_pallas_block`` selects the fused ViT-block CUDA
kernel (``ops/block_kernel.py``), and its "auto" value resolves by the
port's own policy (``models/rovit_kan.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional


@dataclass
class DataConfig:
    dataset_root: Path = Path("data")
    augmented_root: Path = Path("data/Augmented Image")
    original_root: Path = Path("data/Original Image")

    class_names: List[str] = field(default_factory=lambda: [
        "Healthy Leaf",
        "Leaf Holes",
        "Black Spot",
        "Dry Leaf",
    ])

    severity_map: Dict[str, int] = field(default_factory=lambda: {
        "Healthy Leaf": 0,
        "Leaf Holes": 1,
        "Black Spot": 2,
        "Dry Leaf": 3,
    })

    num_classes: int = 4
    image_size: int = 224
    train_val_split: float = 0.8
    # Host-side prefetch depth (the TPU analogue of DataLoader workers).
    prefetch_batches: int = 2
    num_workers: int = 4


@dataclass
class TrainConfig:
    batch_size: int = 32
    epochs: int = 50
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    early_stop_patience: int = 10
    # Gradient accumulation: effective batch = batch_size * accum_steps
    # (optax.MultiSteps; params update every accum_steps micro-batches).
    accum_steps: int = 1
    # Exponential moving average of params for evaluation/serving
    # (ema = d*ema + (1-d)*params after each step). 0 disables (reference
    # parity — the reference has no EMA). When on, validation, the best
    # checkpoint, and downstream evaluation all use the EMA weights.
    ema_decay: float = 0.0
    use_curriculum: bool = True
    # Minimum seconds between best-model DISK writes. 0 (the default,
    # reference parity) checkpoints every val improvement. The cooldown
    # only throttles the disk write — best-model selection still updates in
    # memory every improvement, and the pending best is flushed on
    # completion, early stop, and preemption, so no result changes.
    checkpoint_min_interval_s: float = 0.0
    seeds: List[int] = field(default_factory=lambda: [42, 123, 999])
    stage_1_epochs: int = 10
    stage_2_epochs: int = 25
    stage_3_epochs: int = 40
    stage_4_epochs: int = 50


@dataclass
class LossConfig:
    lambda_ord: float = 1.0
    mu_unc: float = 0.5
    nu_kan: float = 0.5
    focal_gamma: float = 2.0
    # Per-class focal alpha; populated at runtime from dataset class weights.
    focal_alpha: Optional[List[float]] = None


@dataclass
class ModelConfig:
    backbone: str = "deit_tiny_patch16_224"
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    patch_size: int = 16
    pretrained: bool = True
    freeze_backbone: bool = False
    num_classes: int = 4
    # Structural head toggles (ablation variants); persisted into
    # checkpoints so evaluate/serving rebuild the exact architecture.
    with_ordinal: bool = True
    with_uncertainty: bool = True
    with_kan: bool = True
    kan_layers: List[int] = field(default_factory=lambda: [192, 64, 16, 1])
    kan_num_knots: int = 5
    kan_degree: int = 3
    dropout: float = 0.3
    hidden_dim: int = 128
    # Path to converted pretrained weights (a .npz produced by
    # models/convert.py). None -> random init (pretrained flag is then moot,
    # since this environment has no network egress to fetch timm weights).
    pretrained_npz: Optional[Path] = None
    # Opt-in Mixture-of-Experts FFN (models/moe.py, expert-choice routing):
    # moe_experts > 1 turns every moe_every-th backbone block sparse. The
    # flagship is dense (0); these exist for the expert-parallel deployment
    # story (parallel/tensor.py::make_moe_mesh / moe_param_specs).
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 2.0


@dataclass
class PathConfig:
    checkpoints_dir: Path = Path("checkpoints")
    results_dir: Path = Path("results")
    figures_dir: Path = Path("results/figures")
    logs_dir: Path = Path("results/logs")

    def ensure_dirs(self) -> None:
        for p in (self.checkpoints_dir, self.results_dir,
                  self.figures_dir, self.logs_dir):
            Path(p).mkdir(parents=True, exist_ok=True)


@dataclass
class FlagsConfig:
    use_mixup: bool = True
    use_cutmix: bool = True
    mixup_alpha: float = 0.2
    cutmix_alpha: float = 1.0
    mixed_precision: bool = True      # bf16 compute in the backbone
    curriculum: bool = True
    freeze_backbone_epochs: int = 5
    gradient_clip: float = 1.0


@dataclass
class TPUConfig:
    """Execution knobs (no reference analogue); the section keeps the JAX
    package's name."""
    # Data-parallel axis size; -1 = all visible devices.
    data_parallel: int = -1
    mesh_axis_name: str = "data"
    # Attention-only kernels (JAX: ops/attention.py; in the port, the
    # hand-written CUDA kernels of csrc/attention.cu). "auto" applies the
    # policy in models/rovit_kan.py: bf16 inference at >= 512 tokens on the
    # card. The fused block takes precedence where both are on.
    use_pallas_attention: "bool | str" = "auto"
    # Fused KAN kernels (JAX: ops/kan_kernel.py; in the port, the
    # hand-written CUDA kernels of csrc/kan_module.cu). Off by default, as
    # in JAX.
    use_pallas_kan: bool = False
    # Whole-transformer-block fused kernel (ops/block_kernel.py; in the
    # port, the hand-written CUDA block kernel). "auto" applies the policy
    # in models/rovit_kan.py.
    use_pallas_block: "bool | str" = "auto"
    # Training knobs of the JAX package, kept so its config dicts load:
    # single-flat-vector AdamW update, fused augmentation kernel, donated
    # train state, remat (build_model refuses it: not ported), and pipeline
    # microbatches.
    fused_optimizer: bool = True
    # Read by nothing, as in the JAX package: the train step reads the
    # switch from ``train.fused_augment`` (training/trainer.py).
    fused_augment: "bool | str" = "auto"
    donate_state: bool = True
    remat_backbone: bool = False
    pipeline_microbatches: int = 4


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    paths: PathConfig = field(default_factory=PathConfig)
    flags: FlagsConfig = field(default_factory=FlagsConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)

    def get_stage_for_epoch(self, epoch: int) -> int:
        """Curriculum stage for a 1-indexed epoch.

        Mirrors reference `configs/config.py:108-118`: stage 4 always when the
        curriculum flag is off, otherwise 1/2/3/4 split at the stage-epoch
        boundaries.
        """
        if not self.flags.curriculum:
            return 4
        if epoch <= self.train.stage_1_epochs:
            return 1
        if epoch <= self.train.stage_2_epochs:
            return 2
        if epoch <= self.train.stage_3_epochs:
            return 3
        return 4

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        """JSON-safe nested dict (paths stringified) — serialized into
        checkpoints like the reference pickles its config object
        (reference training/trainer.py:319)."""
        def conv(x):
            if dataclasses.is_dataclass(x):
                return {f.name: conv(getattr(x, f.name))
                        for f in dataclasses.fields(x)}
            if isinstance(x, Path):
                return str(x)
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [conv(v) for v in x]
            return x
        return conv(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        cfg = cls()
        for section_name, section in d.items():
            obj = getattr(cfg, section_name, None)
            if obj is None or not isinstance(section, dict):
                continue
            for k, v in section.items():
                if not hasattr(obj, k):
                    continue
                cur = getattr(obj, k)
                if isinstance(cur, Path):
                    v = Path(v)
                setattr(obj, k, v)
        return cfg


#: Backbone width presets. "tiny" is the reference's DeiT-Tiny flagship;
#: "small"/"base" are the standard DeiT-Small/Base widths.
_PRESETS = {
    "tiny": dict(embed_dim=192, num_heads=3),
    "small": dict(embed_dim=384, num_heads=6),
    "base": dict(embed_dim=768, num_heads=12),
}


def get_config(preset: str = "tiny") -> Config:
    """Default config, optionally at a scaled backbone preset
    ("tiny" | "small" | "base"). The KAN tree's input width follows the
    embed dim; everything else (depth 12, patch 16, heads' hidden dims,
    training recipe) is preset-independent."""
    cfg = Config()
    if preset != "tiny":
        p = _PRESETS[preset]
        cfg.model.embed_dim = p["embed_dim"]
        cfg.model.num_heads = p["num_heads"]
        cfg.model.kan_layers = [p["embed_dim"]] + cfg.model.kan_layers[1:]
    return cfg
