"""Train RoViT-KAN end to end, on one card or several, then evaluate it.

    python -m rovit_kan_tpu_torch.cli.train --data_root DATA [--seed 42] \
        [--output_dir outputs/train] [--epochs N] [--batch_size B] \
        [--synthetic [--synthetic_per_class N]] [--fast] [--cpu] [--resume] \
        [--device_cache] [--all_seeds] [--patience P] [--ema_decay D] \
        [--checkpoint_min_interval S] [--preset tiny|small|base] \
        [--profile_dir DIR] [--matmul_precision P] [--pretrained_npz NPZ] \
        [--moe_experts E] [--devices N] [--multihost] \
        [--device_cache_sharded] [--fsdp] [--tensor_parallel T] \
        [--sequence_parallel] [--expert_parallel E] \
        [--pipeline_parallel P [--pipeline_microbatches M]]

The flow of the JAX package's ``scripts/train.py``. A run:
dataloaders over ``DATA/Augmented Image`` (train and validation, a seeded
80/20 split) and ``DATA/Original Image`` (test), with ``--device_cache``
the whole set on the card; the focal alpha from the train split's class
weights; the model, the ``ExperimentLogger`` and the ``Trainer``; ``fit``
(``--resume`` continues from a preemption checkpoint or ``best_model``);
the training curves; and the ``Evaluator`` on the test set with the best
weights (the EMA when ``--ema_decay`` is on). ``--all_seeds`` runs every
seed of ``train.seeds`` and writes ``seed_summary.json``. ``--fast`` sets
the JAX script's smoke-run config (64 px, depth 2, width 32, fp32, 2
epochs at batch 8).

``--profile_dir`` writes a torch.profiler trace of the first epoch
(``utils/profiling.py::trace``) before the fit goes on from the second, as
the JAX script's ``jax.profiler`` trace. ``--matmul_precision`` sets
``torch.set_float32_matmul_precision`` for the plain path. The presets
``small`` and ``base`` (d = 384, 768) train on the plain block: the fused
block's bf16 stages take d of 64 to 192.

``--pretrained_npz`` starts a fresh run from converted weights (the JAX
package's ``.npz``, from ``cli.convert_checkpoint`` or the JAX package's
``save_npz``) laid over the init drawn from ``--seed`` by
``merge_pretrained``; ``--resume`` wins over it. ``--moe_experts E`` (E > 1)
turns every second block's MLP into an expert-choice MoE with E experts
(``models/moe.py``).

Data parallelism, one process per card (``parallel/``): ``--devices N``
(default -1, every visible card) starts N workers on this host, rank r on
``cuda:r``, each running this flow with ``--multihost``, and fails if any
of them fails; ``--cpu --devices N`` starts N workers on the CPU (gloo).
Asking for more cards than are visible raises. ``--multihost`` makes this
process one rank of the job torchrun describes (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): ``python
-m torch.distributed.run --nnodes H --nproc_per_node G -m
rovit_kan_tpu_torch.cli.train --multihost ...``. Every rank loads the same
seeded global batches and trains its rows of each; rank 0 alone writes the
checkpoints, the epoch CSV and the reports. ``--device_cache_sharded``
(implies ``--device_cache``) stores each split sharded over the ranks.
``--fsdp`` shards the parameters, gradients, AdamW moments and EMA over the
ranks (ZeRO-3, ``parallel/fsdp.py``; MoE experts included) and prints each
rank's parameter bytes beside the replicated figure; on one rank there is
nothing to shard over and it trains replicated. Its checkpoints are the
single-card files.

Tensor parallelism (``parallel/tensor.py``): ``--tensor_parallel T`` lays
the ranks out on a 2-D mesh, data x model, with ``--devices N`` counting
every process (data = N / T; a remainder is refused, as the JAX script
refuses it) and shards each block's attention and MLP weights over the T
ranks of a model column, Megatron-style; ``--sequence_parallel`` also
shards the residual stream's tokens over them. ``--fsdp`` composes with
both (FSDP+TP: the data axis shards what the Megatron rule leaves).

Expert parallelism (``--expert_parallel E`` with ``--moe_experts``, which E
must divide): a data x expert mesh, each rank holding E-th of every MoE
block's experts (``parallel/tensor.py::ExpertParallel``). The pipeline
(``--pipeline_parallel P``): a data x pipe mesh, each rank one stage of
depth/P blocks, the GPipe schedule over ``--pipeline_microbatches``
microbatches (default 4, fitted down to divide the local batch;
``parallel/pipeline.py``). ``--devices`` counts every process for both.
``--tensor_parallel T`` with ``--pipeline_parallel P``: the 3-D data x
pipe x model mesh (data = N / (T * P)), each stage's blocks also sharded
over the T ranks of its model line. The final evaluation runs on the model
whole, the stages' or the experts' weights gathered. The flag rules of the
JAX script are checked before any data loads, with its messages. The
checkpoints are the single-card files.

Runs on the card unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
from pathlib import Path

from rovit_kan_tpu_torch.cli import (
    MATMUL_PRECISION,
    MATMUL_PRECISION_HELP,
    MULTIHOST_HELP,
    data_parallel_size,
    set_matmul_precision,
    spawn_workers,
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_root", type=Path, default=Path("data"))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output_dir", type=Path, default=Path("outputs/train"))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--preset", default="tiny",
                   choices=["tiny", "small", "base"],
                   help="backbone width preset (DeiT-Tiny d=192, small "
                        "d=384, base d=768)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic dataset under data_root")
    p.add_argument("--synthetic_per_class", type=int, default=None,
                   help="augmented images per class for --synthetic "
                        "(default 64, 8 with --fast)")
    p.add_argument("--patience", type=int, default=None,
                   help="override config.train.early_stop_patience")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="EMA of params for eval/checkpoint (e.g. 0.999); "
                        "0/absent = off")
    p.add_argument("--checkpoint_min_interval", type=float, default=None,
                   help="min seconds between best-model disk writes "
                        "(config.train.checkpoint_min_interval_s)")
    p.add_argument("--fast", action="store_true",
                   help="tiny model + 2 epochs (smoke test)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the preemption or best_model "
                        "checkpoint in output_dir")
    p.add_argument("--device_cache", action="store_true",
                   help="keep the whole uint8 dataset on the card "
                        "(DeviceLoader: no host decode or copy per step)")
    p.add_argument("--all_seeds", action="store_true",
                   help="run every seed in config.train.seeds (default "
                        "[42, 123, 999]) and report mean/std test metrics")
    p.add_argument("--profile_dir", type=Path, default=None,
                   help="write a torch.profiler trace of the first epoch "
                        "here")
    p.add_argument("--matmul_precision", default=None,
                   choices=sorted(MATMUL_PRECISION),
                   help=MATMUL_PRECISION_HELP)
    p.add_argument("--pretrained_npz", type=Path, default=None,
                   help="converted timm/reference weights "
                        "(cli.convert_checkpoint)")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="turn every 2nd backbone block's FFN into an "
                        "expert-choice MoE with N experts (models/moe.py; "
                        "0 = dense flagship)")
    p.add_argument("--devices", type=int, default=-1,
                   help="data-parallel mesh size (-1 = all): one process "
                        "per card")
    p.add_argument("--multihost", action="store_true", help=MULTIHOST_HELP)
    p.add_argument("--device_cache_sharded", action="store_true",
                   help="implies --device_cache, storing each split "
                        "sharded over the mesh (1/dp of it per card, "
                        "shard-local gathers, stratified batches + "
                        "per-shard shuffle) instead of a copy on every "
                        "card")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: shard params, grads, optimizer moments "
                        "and EMA over the data axis instead of "
                        "replicating (parallel/fsdp.py; composes with "
                        "--tensor_parallel into the FSDP+TP hybrid)")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="model-axis size of a 2-D (data x model) mesh; "
                        "shards attention+MLP weights Megatron-style "
                        "(parallel/tensor.py). Total devices = "
                        "data x model")
    p.add_argument("--sequence_parallel", action="store_true",
                   help="with --tensor_parallel: also shard the residual "
                        "stream's token dim over the model axis "
                        "(parallel/tensor.py::seq_sharding)")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="pipe-axis size of a (data x pipe) mesh: the "
                        "blocks split into this many GPipe stages "
                        "(parallel/pipeline.py). Total devices = data x "
                        "pipe")
    p.add_argument("--pipeline_microbatches", type=int, default=None,
                   help="microbatches per local batch for the GPipe "
                        "schedule (config.tpu.pipeline_microbatches, "
                        "default 4)")
    p.add_argument("--expert_parallel", type=int, default=1,
                   help="expert-axis size of a (data x expert) mesh: each "
                        "device holds moe_experts / E experts of every MoE "
                        "block (parallel/tensor.py::ExpertParallel)")
    return p.parse_args(argv)


def check_flags(args: argparse.Namespace) -> None:
    """The JAX script's flag rules, with its messages, then the remainder
    of ``--devices`` over the model axes; raises SystemExit before any data
    loads."""
    if args.sequence_parallel:
        if args.tensor_parallel <= 1:
            raise SystemExit("--sequence_parallel requires "
                             "--tensor_parallel > 1 (it shards over "
                             "the model axis)")
        if args.pipeline_parallel > 1:
            raise SystemExit("--sequence_parallel composes with the "
                             "GSPMD tensor-parallel path only; the "
                             "pipeline stages run inside shard_map "
                             "where sharding constraints don't apply")
    if args.expert_parallel > 1:
        if args.moe_experts <= 1:
            raise SystemExit("--expert_parallel requires --moe_experts > 1 "
                             "(there must be experts to shard)")
        if args.moe_experts % args.expert_parallel != 0:
            raise SystemExit(f"--moe_experts {args.moe_experts} must be "
                             f"divisible by --expert_parallel "
                             f"{args.expert_parallel}")
        if args.tensor_parallel > 1 or args.pipeline_parallel > 1:
            raise SystemExit("--expert_parallel uses its own "
                             "('data', 'expert') mesh and does not compose "
                             "with --tensor_parallel/--pipeline_parallel")
    if args.fsdp and (args.pipeline_parallel > 1
                      or args.expert_parallel > 1):
        raise SystemExit("--fsdp composes with --tensor_parallel only; "
                         "pipeline/expert parallelism keep their own "
                         "stacked param layouts (parallel/fsdp.py)")
    if args.moe_experts > 1 and args.pipeline_parallel > 1:
        raise SystemExit("--moe_experts does not compose with "
                         "--pipeline_parallel: the GPipe stage scan "
                         "requires identical per-block param structures "
                         "(parallel/pipeline.py), and MoE blocks differ")
    model_axes = (args.tensor_parallel * args.pipeline_parallel
                  * args.expert_parallel)
    if args.devices != -1 and args.devices % model_axes != 0:
        # The floor-divides below would silently idle the remainder.
        raise SystemExit(
            f"--devices {args.devices} is not divisible by "
            f"pipeline*tensor*expert parallel = {model_axes}; "
            f"{args.devices % model_axes} device(s) would sit idle")


def make_run_mesh(args: argparse.Namespace):
    """This process's mesh, with the JAX script's mesh line: the 3-D data x
    pipe x model mesh under ``--tensor_parallel`` with
    ``--pipeline_parallel``, the 2-D data x model mesh under
    ``--tensor_parallel``, data x pipe under ``--pipeline_parallel``, data x
    expert under ``--expert_parallel`` (``--devices`` counting every
    process), else the data mesh."""
    from rovit_kan_tpu_torch.config import TPUConfig
    from rovit_kan_tpu_torch.parallel.mesh import (
        make_2d_mesh,
        make_mesh,
        make_moe_mesh,
        make_pipeline_mesh,
    )
    device = "cpu" if args.cpu else None
    micro = args.pipeline_microbatches or TPUConfig().pipeline_microbatches
    if args.tensor_parallel > 1 and args.pipeline_parallel > 1:
        n = args.tensor_parallel * args.pipeline_parallel
        data = -1 if args.devices == -1 else args.devices // n
        mesh = make_pipeline_mesh(data, args.pipeline_parallel,
                                  model=args.tensor_parallel, device=device)
        print(f"Mesh: data={mesh.size} x pipe={mesh.axis_size('pipe')} x "
              f"model={mesh.model_size} (pipeline + tensor parallel, "
              f"{micro} microbatches)")
        return mesh
    for n, make, what in (
            (args.tensor_parallel, make_2d_mesh, "tensor parallel"),
            (args.pipeline_parallel, make_pipeline_mesh,
             f"pipeline parallel, {micro} microbatches"),
            (args.expert_parallel, make_moe_mesh,
             f"expert parallel, {args.moe_experts} experts")):
        if n > 1:
            # --devices counts every device; the data axis is the rest.
            data = -1 if args.devices == -1 else args.devices // n
            mesh = make(data, n, device=device)
            axis, = mesh.inner_axes
            print(f"Mesh: data={mesh.size} x {axis}="
                  f"{mesh.axis_size(axis)} ({what})")
            return mesh
    return make_mesh(args.devices, device=device)


def build_config(args: argparse.Namespace):
    """The run's ``Config``: the flagship, the paths under ``output_dir``
    and the flags' overrides, as the JAX script sets them."""
    from rovit_kan_tpu_torch.config import get_config

    config = get_config(args.preset)
    if args.pretrained_npz:
        config.model.pretrained_npz = args.pretrained_npz
    if args.moe_experts > 1:
        config.model.moe_experts = args.moe_experts
    if args.pipeline_parallel > 1 and args.pipeline_microbatches:
        config.tpu.pipeline_microbatches = args.pipeline_microbatches
    config.paths.checkpoints_dir = args.output_dir / "checkpoints"
    config.paths.results_dir = args.output_dir / "results"
    config.paths.logs_dir = args.output_dir / "logs"
    if args.epochs:
        config.train.epochs = args.epochs
    if args.batch_size:
        config.train.batch_size = args.batch_size
    if args.fast:
        config.data.image_size = 64
        config.train.epochs = args.epochs or 2
        config.train.batch_size = args.batch_size or 8
        config.train.stage_1_epochs = 1
        config.train.stage_2_epochs = 1
        config.train.stage_3_epochs = 1
        config.flags.freeze_backbone_epochs = 1
        config.flags.mixed_precision = False
        config.model.depth = 2
        config.model.embed_dim = 32
        config.model.num_heads = 2
        config.model.hidden_dim = 16
        config.model.kan_layers = [32, 8, 1]
        config.tpu.use_pallas_attention = False
        config.tpu.use_pallas_kan = False
    if args.patience is not None:
        config.train.early_stop_patience = args.patience
    if args.ema_decay is not None:
        config.train.ema_decay = args.ema_decay
    if args.checkpoint_min_interval is not None:
        config.train.checkpoint_min_interval_s = args.checkpoint_min_interval
    return config


def run_one(config, seed: int, out_dir: Path, aug_root: Path,
            orig_root: Path, device: str, resume: bool, device_cache: bool,
            profile_dir: Path = None, mesh=None,
            device_cache_sharded: bool = False, fsdp: bool = False,
            sequence_parallel: bool = False):
    """One training run and its test evaluation; returns the test metrics,
    or None when the run was preempted. With ``profile_dir`` the first
    epoch runs under a torch.profiler trace written there. ``mesh``: this
    rank's data or data x model mesh (rank 0 writes the files); ``fsdp``
    shards the state over its data axis, ``sequence_parallel`` the
    residual stream's tokens over its model axis."""
    from rovit_kan_tpu_torch.data.dataset import create_dataloaders
    from rovit_kan_tpu_torch.evaluation.evaluator import (
        Evaluator,
        load_model_for_evaluation,
    )
    from rovit_kan_tpu_torch.models.rovit_kan import (
        build_model,
        count_parameters,
    )
    from rovit_kan_tpu_torch.parallel.multihost import process_index
    from rovit_kan_tpu_torch.results.logger import ExperimentLogger
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from rovit_kan_tpu_torch.utils.checkpoint import promote_staging

    cfg = copy.deepcopy(config)
    cfg.paths.checkpoints_dir = out_dir / "checkpoints"
    cfg.paths.results_dir = out_dir / "results"
    cfg.paths.logs_dir = out_dir / "logs"

    train_l, val_l, test_l = create_dataloaders(
        aug_root, orig_root, cfg.data.class_names, cfg.data.severity_map,
        batch_size=cfg.train.batch_size,
        train_val_split=cfg.data.train_val_split, seed=seed,
        image_size=cfg.data.image_size, prefetch=cfg.data.prefetch_batches,
        num_workers=cfg.data.num_workers)
    # Focal alpha from the train split's class weights.
    focal_alpha = train_l.dataset.get_class_weights()
    cfg.loss.focal_alpha = focal_alpha.tolist()
    if device_cache or device_cache_sharded:
        from rovit_kan_tpu_torch.data.device_cache import (
            device_cache_loaders,
        )
        train_l, val_l, test_l = device_cache_loaders(
            train_l.dataset, val_l.dataset, test_l.dataset,
            cfg.train.batch_size, seed=seed, device=device, mesh=mesh,
            shard_data=device_cache_sharded)
        print(f"Device cache: {train_l.nbytes / 1e6:.0f} MB train split "
              f"resident on the card"
              + (f" (shard {mesh.rank} of {mesh.size})"
                 if train_l.sharded else ""))

    main = process_index() == 0
    tp = mesh is not None and "model" in mesh.axis_names
    act_sharding = None
    if sequence_parallel:
        from rovit_kan_tpu_torch.parallel.tensor import seq_sharding
        act_sharding = seq_sharding(mesh)
        print("Sequence parallel: residual stream tokens sharded over "
              f"model={mesh.model_size}")
    model = build_model(cfg, device=device, seed=seed,
                        act_sharding=act_sharding)
    n_params = count_parameters(model)["total"]
    logger = ExperimentLogger(cfg.paths.logs_dir, "train") if main else None
    if fsdp and (mesh is None or mesh.size == 1):
        print("FSDP: data axis has 1 device — nothing to shard over; "
              "params stay "
              + ("tensor-parallel sharded (Megatron specs only)" if tp
                 else "replicated"))
        fsdp = False
    elif fsdp:
        from rovit_kan_tpu_torch.parallel.fsdp import (
            fsdp_param_specs,
            sharded_size,
        )
        from rovit_kan_tpu_torch.parallel.tensor import param_specs
        print(f"FSDP: params/grads/moments/EMA sharded over "
              f"data={mesh.size} (ZeRO-3)")
        shard_mb = sharded_size(
            model, fsdp_param_specs(model, mesh, tp=tp), mesh,
            param_specs(model) if tp else None) / 1e6
        print(f"FSDP state/device: params {shard_mb:.1f} MB (replicated: "
              f"{sharded_size(model, {}, mesh) / 1e6:.1f} MB); AdamW "
              f"moments and EMA shard identically")
    trainer = Trainer(model, train_l, val_l, cfg, logger=logger,
                      focal_alpha=focal_alpha, seed=seed, mesh=mesh,
                      fsdp=fsdp)
    # The model whole for a while (under FSDP, TP or EP its sharded leaves
    # are gathered, under the pipeline every stage's blocks, as the JAX
    # script's merge_params): the merge and the final evaluation read it.
    whole = (trainer.sharded.full_module if trainer.sharded is not None
             else contextlib.nullcontext)

    start_epoch = 1
    ck_dir = Path(cfg.paths.checkpoints_dir)
    # A preemption checkpoint is by construction the latest state, so it
    # wins over best_model (a completed fit deletes it). Either must be a
    # committed checkpoint: a crash mid-write leaves a torso that is never
    # loaded.
    resume_name = None
    if promote_staging(ck_dir / "preempt_model"):
        resume_name = "preempt_model"
    elif promote_staging(ck_dir / "best_model"):
        resume_name = "best_model"
    elif resume and ((ck_dir / "preempt_model").exists()
                     or (ck_dir / "best_model").exists()):
        print("WARNING: checkpoint directory holds only torn "
              "(unfinalized) checkpoints — starting fresh")
    if resume and resume_name:
        state, start_epoch = trainer.resume(resume_name)
        # Epochs the previous process logged past this restore point were
        # discarded by the restore: drop their CSV rows.
        dropped = logger.truncate_from(start_epoch) if main else 0
        if dropped:
            print(f"Dropped {dropped} stale epoch rows past the restore "
                  f"point from {logger.csv_path}")
        print(f"Resumed from epoch {start_epoch - 1} ({resume_name})")
    else:
        if cfg.model.pretrained_npz:
            from rovit_kan_tpu_torch.models.convert import (
                jax_state_dict,
                load_npz,
                merge_pretrained,
                to_jax_params,
            )
            print(f"Loading pretrained weights: {cfg.model.pretrained_npz}")
            pre = load_npz(cfg.model.pretrained_npz)
            # build_model drew the init from the seed; merge over it.
            with whole():
                params = jax_state_dict(model, merge_pretrained(
                    to_jax_params(model), pre))
            state = trainer.init_state(params=params)
        else:
            state = trainer.init_state()
        if main and logger.reset():
            # A fresh run into a directory holding a previous run's CSV
            # replaces it; appending would mix two epoch lineages.
            print(f"Replaced previous epoch CSV at {logger.csv_path}")
    print("Parameters:", n_params)

    if profile_dir is not None:
        from rovit_kan_tpu_torch.utils.profiling import trace
        with trace(profile_dir) if main else contextlib.nullcontext():
            state, _ = trainer.train_epoch(state, start_epoch)
        start_epoch += 1
        print(f"Profiler trace written to {profile_dir}")

    result = trainer.fit(state, start_epoch=start_epoch)
    if result["preempted"]:
        # A half-trained model must never produce "final" metrics.
        print("Run preempted — skipping final evaluation; re-run with "
              "--resume to continue")
        return None
    if main:
        logger.plot_training_curves()

    # Evaluate the weights model selection and the checkpoint use: the EMA
    # when it is on.
    gathered = whole()
    if (resume_name == "preempt_model" and start_epoch > 1
            and not result["improved"] and (ck_dir / "best_model").exists()):
        # Resumed from a preemption checkpoint and no epoch beat the
        # restored best: the true best lives on disk.
        _, eval_weights = load_model_for_evaluation(
            ck_dir / "best_model", cfg, device=device)
    else:
        eval_weights = trainer.eval_params(result["best_state"])
        if trainer.sharded is not None:
            # This rank's shards: gathered into the model for the test.
            gathered, eval_weights = whole(eval_weights), None
    with gathered:
        evaluator = Evaluator(model, eval_weights, test_l, cfg,
                              output_dir=cfg.paths.results_dir)
        return evaluator.evaluate(save=main)


def main(argv=None):
    """Run the training; returns the test metrics (``--all_seeds``: the
    seed summary), or None when preempted."""
    args = parse_args(argv)
    check_flags(args)
    mesh = None
    if args.multihost:
        mesh = make_run_mesh(args)
        print(f"Multi-host: rank {mesh.global_rank} of {mesh.world} on "
              f"{mesh.device} ({mesh.backend or 'no process group'})")
    else:
        n = data_parallel_size(args.devices, args.cpu)
        if n > 1:
            spawn_workers(
                [sys.executable, "-m", "rovit_kan_tpu_torch.cli.train",
                 *(sys.argv[1:] if argv is None else argv), "--multihost"],
                n)
            return _rank0_result(args)
        if max(args.tensor_parallel, args.pipeline_parallel,
               args.expert_parallel) > 1:
            mesh = make_run_mesh(args)   # one process: the JAX error
    set_matmul_precision(args.matmul_precision)
    import numpy as np

    from rovit_kan_tpu_torch import resolve_device
    from rovit_kan_tpu_torch.data.synthetic import generate_synthetic_dataset
    from rovit_kan_tpu_torch.parallel.multihost import barrier, process_index

    device = "cpu" if args.cpu else "cuda"
    resolve_device(device)
    if mesh is not None:
        device = str(mesh.device)
    np.random.seed(args.seed)
    config = build_config(args)

    aug_root = args.data_root / "Augmented Image"
    orig_root = args.data_root / "Original Image"
    if args.synthetic and process_index() == 0:
        n = args.synthetic_per_class or (8 if args.fast else 64)
        generate_synthetic_dataset(aug_root, n_per_class=n,
                                   size=config.data.image_size,
                                   class_names=config.data.class_names,
                                   seed=args.seed)
        generate_synthetic_dataset(orig_root, n_per_class=max(n // 2, 2),
                                   size=config.data.image_size,
                                   class_names=config.data.class_names,
                                   seed=args.seed + 1)
    barrier()                     # the other ranks read rank 0's images

    def run(seed, out_dir):
        return run_one(config, seed, out_dir, aug_root, orig_root, device,
                       args.resume, args.device_cache, args.profile_dir,
                       mesh, args.device_cache_sharded, args.fsdp,
                       args.sequence_parallel)

    if not args.all_seeds:
        metrics = run(args.seed, args.output_dir)
        if metrics is not None:
            print("Done. Test accuracy:", metrics["accuracy"])
        return metrics

    # Multi-seed sweep over config.train.seeds.
    all_metrics = {}
    for seed in config.train.seeds:
        print(f"===== seed {seed} =====")
        m = run(seed, args.output_dir / f"seed_{seed}")
        if m is None:             # preempted: stop the sweep cleanly
            print(f"Sweep preempted at seed {seed}; re-run with --resume")
            return None
        all_metrics[seed] = m
    keys = ("accuracy", "macro_f1", "weighted_f1", "mae", "spearman_rho",
            "brier_score", "ece")
    summary = {}
    for k in keys:
        vals = np.asarray([m[k] for m in all_metrics.values()], np.float64)
        summary[k] = {"mean": float(vals.mean()), "std": float(vals.std()),
                      "per_seed": {str(s): float(m[k])
                                   for s, m in all_metrics.items()}}
    if process_index() == 0:
        args.output_dir.mkdir(parents=True, exist_ok=True)
        (args.output_dir / "seed_summary.json").write_text(
            json.dumps(summary, indent=2))
    print("Seed sweep summary (mean ± std):")
    for k in keys:
        print(f"  {k:14s} {summary[k]['mean']:.4f} ± {summary[k]['std']:.4f}")
    return summary


def _rank0_result(args):
    """What rank 0 wrote: the seed summary or the test metrics (None when
    the run was preempted)."""
    path = (args.output_dir / "seed_summary.json" if args.all_seeds
            else args.output_dir / "results" / "test_metrics.json")
    return json.loads(path.read_text()) if path.exists() else None


if __name__ == "__main__":
    main()
