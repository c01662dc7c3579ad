"""Training orchestration: projection -> classifier -> reliability.

Counterpart of `jaeger_tpu/commands/train.py` (``train_fragment_core``):
config-driven branch training with convergence markers, per-epoch
checkpoints and resume (optimizer state included), callback state
persistence, frequency-bias initialization, the self-supervised ArcFace
projection pretraining (``self_supervised_pretraining`` with a
``model.projection`` section), reliability data generation
(``generate_reliability``, :mod:`jaeger_tpu_torch.dataops.
reliability_generator`), reliability threshold tuning and calibration, and
the export: a flax-msgpack bundle both packages load (the projection head's
leaves included), with a calibrated ``<out>/int8`` bundle beside it (the
port's ``quantize_bundle``). The inner loop is
:mod:`jaeger_tpu_torch.train.loop`.

The port also writes ``<out>/history.csv`` (one row per branch epoch).
Multi-process data-parallel training runs under a ``torch.distributed``
process group (``train --coordinator``; the primary process writes every
file, the others generate reliability data into ``<dir>.proc<K>``), and
a ``model.parallel.seq_axis`` config trains sequence-sharded Hyena blocks
(:func:`train_fragment_core`).
"""

from __future__ import annotations

import copy
import csv
import logging
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from jaeger_tpu_torch.models.artifacts import (init_params, load_state,
                                               save_model)
from jaeger_tpu_torch.models.builder import build_model
from jaeger_tpu_torch.parallel import multihost as mh
from jaeger_tpu_torch.parallel.mesh import (mesh_of, pad_to_multiple,
                                            use_mesh, visible_width)
from jaeger_tpu_torch.train import data as data_lib
from jaeger_tpu_torch.train import losses as losses_lib
from jaeger_tpu_torch.train.callbacks import build_callbacks
from jaeger_tpu_torch.train.checkpoint import (CheckpointManager,
                                               TrainingStatePersistence,
                                               resolve_resume_stage,
                                               write_convergence_marker)
from jaeger_tpu_torch.train.loop import (StepConfig, TrainState,
                                         flax_params,
                                         make_dispatching_train_step,
                                         model_inputs, to_device)
from jaeger_tpu_torch.train.optimizers import (get_learning_rate,
                                               make_optimizer,
                                               set_learning_rate)
from jaeger_tpu_torch.utils.config import load_model_config
from jaeger_tpu_torch.utils.devices import resolve_device

logger = logging.getLogger("jaeger_tpu_torch")


def _fragment_paths(train_cfg: dict, key: str = "fragment_classifier_data"):
    """Flatten a data section into paths, labels and classes per split."""
    out: dict[str, dict] = {}
    for split, entries in (train_cfg.get(key) or {}).items():
        paths, labels, classes = [], [], []
        for entry in entries:
            paths.extend(entry.get("path", []))
            labels.extend(entry.get("label", []))
            classes.extend(entry.get("class", []))
        out[split] = {"paths": paths, "label": labels, "class": classes}
    return out


def _label_map(sp: dict, kind: str = "classifier") -> dict[int, int] | None:
    src = sp.get(f"{kind}_labels", [])
    dst = sp.get(f"{kind}_labels_map", [])
    if src and dst:
        return {int(a): int(b) for a, b in zip(src, dst)}
    return None


def _class_weights(train_cfg: dict, key: str, num_classes: int, device):
    cw = train_cfg.get(key)
    if not cw:
        return None
    weights = np.ones(num_classes, np.float32)
    for k, v in cw.items():
        weights[int(k)] = float(v)
    return torch.from_numpy(weights).to(device)


def make_eval_fn(model, loss_name: str, device,
                 output_key: str = "prediction"):
    """``evaluate(batches, max_steps) -> {val_loss, val_accuracy}``: the
    eval-mode forward of one head, the loss without its config parameters
    (as the JAX evaluator)."""
    loss_fn = losses_lib.LOSSES[loss_name]

    def evaluate(batches, max_steps: int) -> dict:
        losses, accs = [], []
        with torch.inference_mode():
            for i, batch in enumerate(batches):
                if i >= max_steps:
                    break
                dev = to_device(batch, device)
                logits = model(**model_inputs(dev),
                               heads=(output_key,))[output_key]
                labels = dev["labels"]
                losses.append(float(loss_fn(labels, logits)))
                if logits.shape[-1] == 1:
                    acc = torch.mean(((logits[:, 0] > 0).float()
                                      == labels.reshape(-1)).float())
                else:
                    acc = torch.mean((torch.argmax(logits, -1)
                                      == torch.argmax(labels, -1)).float())
                accs.append(float(acc))
        if not losses:
            return {}
        return {"val_loss": float(np.mean(losses)),
                "val_accuracy": float(np.mean(accs))}

    return evaluate


def _run_branch(branch: str, state: TrainState, step_fn, make_train_batches,
                make_val_batches, epochs: int, steps_per_epoch: int,
                val_steps: int, ckpt_dir: Path, callbacks: dict, evaluate,
                generator, start_epoch: int = 0):
    """One branch's epoch loop with callbacks and checkpoints."""
    mgr = CheckpointManager(ckpt_dir)
    persist = TrainingStatePersistence(ckpt_dir)
    history: list[dict] = []
    nan_guard = callbacks.get("nan_guard")
    early = callbacks.get("early_stopping")
    reduce_lr = callbacks.get("reduce_lr")
    csv_logger = callbacks.get("csv_logger")
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        metrics = None
        for i, batch in enumerate(make_train_batches(epoch)):
            if i >= steps_per_epoch:
                break
            state, metrics = step_fn(state, batch, generator)
            if nan_guard is not None and i % 50 == 0:
                if nan_guard.on_step(float(metrics["loss"])):
                    logger.error(f"{branch}: non-finite loss, stopping")
                    return state, history
        if metrics is None:
            break
        epoch_metrics = {k: float(v) for k, v in metrics.items()}
        if make_val_batches is not None and val_steps > 0:
            epoch_metrics.update(evaluate(make_val_batches(), val_steps))
        epoch_metrics["epoch_time_s"] = time.time() - t0
        history.append({"epoch": epoch, **epoch_metrics})
        logger.info(f"{branch} epoch {epoch}: {epoch_metrics}")
        if csv_logger is not None:
            csv_logger.on_epoch_end(epoch, epoch_metrics)
        mgr.save(epoch, state.variables, epoch_metrics,
                 opt_state=state.opt_state)
        lr = get_learning_rate(state.opt_state)
        if reduce_lr is not None:
            new_lr = reduce_lr.on_epoch_end(epoch_metrics, lr, epoch=epoch)
            if new_lr is not None:
                logger.info(f"{branch}: reducing lr {lr} -> {new_lr}")
                state.opt_state = set_learning_rate(state.opt_state, new_lr)
                lr = new_lr
        persist.save(epoch, lr, callbacks)
        if early is not None and early.on_epoch_end(
                epoch_metrics, state.params, epoch=epoch):
            logger.info(f"{branch}: early stopping at epoch {epoch}")
            if early.restore_best_weights and early.best_params is not None:
                with torch.no_grad():
                    for k, p in state.params.items():
                        p.copy_(early.best_params[k])
            break
    if csv_logger is not None:
        csv_logger.close()
    return state, history


#: names our own training layout writes into the output directory
_OWN_ARTIFACTS = frozenset({
    "checkpoints", "params.msgpack", "project.yaml", "classes.yaml",
    "reliability_data", "reliability_threshold.tsv", "history.csv",
    "refine.yaml", "int8",
})


def ensure_save_path_available(path, force: bool = False,
                               resuming: bool = False) -> None:
    """Refuse to train into a directory holding content this layout did
    not write (``--force`` bypasses it)."""
    path = Path(path)
    if force or resuming or not path.exists():
        return
    foreign = [c.name for c in path.iterdir()
               if c.name not in _OWN_ARTIFACTS
               and not c.name.endswith((".log", ".csv"))]
    if foreign:
        logger.warning("output directory %s already contains %s. Use "
                       "--force to overwrite.", path, sorted(foreign)[:5])
        raise SystemExit(1)


def _apply_frequency_biases(config, model, train_paths, train_cfg, sp,
                            reliability_paths=None, branches=None) -> None:
    """Set dense biases configured with ``bias_initializer:
    calculate_from_data`` to the class-frequency log-prior of the branch's
    last training file (softmax, or sigmoid for a binary loss)."""
    model_cfg = config.get("model", {})
    state = model.state_dict()
    for branch, loss_key, map_kind, key in (
            ("classifier", "loss_classifier", "classifier", "classifier"),
            ("reliability_model", "loss_reliability", "reliability",
             "reliability")):
        if branches is not None and branch not in branches:
            continue
        branch_paths = (reliability_paths if branch == "reliability_model"
                        else train_paths) or []
        bcfg = model_cfg.get(branch) or {}
        for i, entry in enumerate(bcfg.get("hidden_layers", [])):
            init = str((entry.get("config") or {}).get("bias_initializer",
                                                       ""))
            if "calculate_from" not in init or not branch_paths:
                continue
            kind = ("sigmoid" if "binary" in str(train_cfg.get(loss_key, "")
                                                 or "") else "softmax")
            lmap = sp.get(f"{map_kind}_labels_map") or []
            name = f"{key}.{entry.get('name')}_{i}.bias"
            if name not in state:
                logger.warning(f"bias_initializer target {name} not found; "
                               f"skipping")
                continue
            bias = data_lib.class_frequency_bias(
                branch_paths[-1], kind=kind, label_map=list(lmap))
            want = state[name].shape[0]
            if bias.shape[0] != want:
                if want % bias.shape[0]:
                    logger.warning(f"class-frequency bias length mismatch "
                                   f"for {name}")
                    continue
                bias = np.resize(bias, want)
            with torch.no_grad():
                state[name].copy_(torch.from_numpy(bias))
            logger.info(f"initialized {name} from label frequencies of "
                        f"{branch_paths[-1]}")


def _decide_seq_mesh(config: dict, dev):
    """The sequence mesh of a ``model.parallel.seq_axis`` config:
    ``training.seq_shard`` devices (capped by the visible cards; on the
    CPU it repeats the CPU), else every visible card. None when the
    config has no ``seq_axis`` or the width is 1: the run then uses the
    model without the knob."""
    model_cfg = config.get("model", config)
    seq_axis = (model_cfg.get("parallel") or {}).get("seq_axis")
    if not seq_axis:
        return None
    want = int(config.get("training", {}).get("seq_shard", 0) or 0)
    n_avail = visible_width(dev, max(want, 1))
    width = max(1, min(want or n_avail, n_avail))
    if width <= 1:
        return None
    logger.info(f"sequence-sharded Hyena training over {width} devices "
                f"(axis {seq_axis!r})")
    return mesh_of(dev, width, str(seq_axis))


def train_fragment_core(
    config_path: str,
    output_dir: str | None = None,
    epochs_override: int | None = None,
    steps_override: int | None = None,
    batch_override: int | None = None,
    save: bool = True,
    self_supervised_pretraining: bool = False,
    generate_reliability: bool | None = None,
    from_last_checkpoint: bool = False,
    force: bool = False,
    ignore_convergence: bool = False,
    only_classification_head: bool = False,
    only_reliability_head: bool = False,
    only_save: bool = False,
    id_threshold: float | None = None,
    synthetic_ood_threshold: float | None = None,
    synthetic_ood_multiplier: float | None = None,
    masking: bool | None = None,
    precision: str | None = None,
    meta: str | None = None,
    device=None,
) -> dict:
    """Train the projection, classifier and reliability branches of
    ``config_path`` on ``device`` (default ``cuda``; raises without CUDA
    unless ``device="cpu"``) and export the bundle. Returns the results
    dict (model name, history, parameter count, paths).

    Under a ``torch.distributed`` process group (``train --coordinator``)
    the run is data parallel: the global batch is padded to a multiple of
    the world size, each process trains on its rows of it, and only the
    primary process writes files. A ``model.parallel.seq_axis`` config
    length-shards its Hyena blocks over the mesh that
    :func:`_decide_seq_mesh` picks, and the whole run (steps, evaluation,
    generation, threshold tuning) runs under that ambient mesh; without
    one the model is built without the knob."""
    dev = resolve_device(device)
    config = load_model_config(config_path)
    seq_mesh = _decide_seq_mesh(config, dev)
    with use_mesh(seq_mesh):
        model_cfg = config.get("model", {})
        train_cfg = config.get("training", {})
        sp = model_cfg.get("string_processor", {})
        if masking is not None:
            model_cfg["use_masking"] = bool(masking)
        policy = str(precision if precision is not None
                     else train_cfg.get("mixed_precision", "") or "").lower()
        compute_dtype = (torch.bfloat16 if policy in (
            "bfloat16", "mixed_bfloat16", "bf16", "fp16", "mixed_float16",
            "float16") else torch.float32)

        seed = int(model_cfg.get("seed", 42))
        build_cfg = config
        if seq_mesh is None and (model_cfg.get("parallel") or {}).get(
                "seq_axis"):
            # no mesh materialized: run the twin without the knob (the
            # parameter tree is the same)
            build_cfg = copy.deepcopy(config)
            build_cfg["model"]["parallel"].pop("seq_axis")
        model = build_model(build_cfg, dtype=compute_dtype)
        load_state(model, init_params(
            config, torch.Generator().manual_seed(seed)))
        model.to(dev)
        generator = torch.Generator(device=dev).manual_seed(seed)
        crop_nt = model.crop_nt
        num_classes = int(model_cfg.get("classifier_out_dim", 3))

        out_root = Path(output_dir or train_cfg.get("model_saving", {}).get(
            "path", "model_out"))
        ckpt_root = out_root / "checkpoints"
        ensure_save_path_available(out_root, force=force,
                                   resuming=from_last_checkpoint)
        data_format = sp.get("data_format", "csv")
        batch_size = int(batch_override or train_cfg.get("batch_size", 64))
        global_batcher = None
        if mh.is_distributed() and seq_mesh is None:
            # data parallel: every process loads the identical global batch
            # stream and trains on its row slice; batch_size is the GLOBAL
            # batch
            batch_size = pad_to_multiple(batch_size, mh.process_count())
            global_batcher = mh.GlobalBatcher()
            logger.info(f"multi-process training: process "
                        f"{mh.process_index()}/{mh.process_count()}, global "
                        f"batch {batch_size}")
        elif (seq_mesh is None and dev.type == "cuda"
              and torch.cuda.device_count() > 1):
            # JAX's train spans every local device in one process; the
            # port's data parallelism is one process a card
            logger.warning(
                f"training on one of {torch.cuda.device_count()} cards: "
                f"start one process a card with --coordinator HOST:PORT "
                f"--num-processes N --process-id K to train on all")

        if only_save:
            from_last_checkpoint = True
        start_epochs = {"projection": 0, "classifier": 0, "reliability": 0}
        resume_entry = resume_stage = None
        if from_last_checkpoint:
            stage, entry = resolve_resume_stage(ckpt_root)
            if stage is not None:
                load_state(model, CheckpointManager(ckpt_root / stage)
                           .restore(entry))
                model.to(dev)
                start_epochs[stage] = entry["epoch"] + 1
                resume_entry, resume_stage = entry, stage
                logger.info(f"resumed from {stage} checkpoint epoch "
                            f"{entry['epoch']}")

        def resume_opt_state(stage: str, state: TrainState) -> TrainState:
            if resume_stage == stage and resume_entry is not None:
                state.opt_state = CheckpointManager(
                    ckpt_root / stage).restore_opt_state(resume_entry,
                                                         state.opt_state)
            return state

        paths = _fragment_paths(train_cfg)
        train_paths = paths.get("train", {}).get("paths", [])
        val_paths = paths.get("validation", {}).get("paths", [])
        label_map = _label_map(sp)
        if not any(start_epochs.values()):
            _apply_frequency_biases(config, model, train_paths, train_cfg, sp,
                                    branches=("classifier",))

        def csv_batches(paths_, epoch_seed, repeat=True):
            return data_lib.batches_from_csv(
                paths_, batch_size=batch_size, crop_nt=crop_nt,
                num_classes=num_classes,
                shuffle_buffer=int(sp.get("buffer_size", 50000)),
                seed=seed + epoch_seed, label_map=label_map, repeat=repeat)

        def npz_batches(paths_, epoch_seed, repeat=True):
            val = not repeat
            crop_sizes = sp.get("validation_crop_sizes" if val
                                else "crop_sizes") or sp.get("crop_sizes")
            if crop_sizes:
                return data_lib.cropped_batches_from_npz(
                    paths_[0], batch_size=batch_size, num_classes=num_classes,
                    crop_sizes=crop_sizes,
                    strides=sp.get("validation_strides" if val else "strides"),
                    overlap=sp.get("validation_overlap" if val else "overlap"),
                    crop_mode=sp.get("crop_mode", "all"),
                    seed=seed + epoch_seed, repeat=repeat)
            return data_lib.batches_from_npz(
                paths_[0], batch_size=batch_size, num_classes=num_classes,
                seed=seed + epoch_seed, repeat=repeat)

        make_raw = npz_batches if data_format == "numpy" else csv_batches
        shuffle_frames = bool(sp.get("shuffle_frames", False))

        def make_batches(paths_, epoch_seed, repeat=True):
            batches = make_raw(paths_, epoch_seed, repeat=repeat)
            if shuffle_frames and repeat:
                batches = data_lib.with_frame_shuffle(
                    batches, seed=seed + 7919 * (epoch_seed + 1))
            return batches

        reg_specs = tuple(model.regularizer_specs())
        history: dict = {}
        results: dict = {"model": model_cfg.get("name", "jaeger_model")}

        def converged(branch_dir):
            if ignore_convergence:
                return None
            from jaeger_tpu_torch.train.checkpoint import (
                read_convergence_marker)
            return read_convergence_marker(branch_dir)

        def run(branch, step_cfg, tx, batches, val_batches, epochs, steps,
                val_steps, loss_name, output_key):
            state = resume_opt_state(branch, TrainState.create(model, tx))
            step_fn = make_dispatching_train_step(
                model, step_cfg, dev, global_batcher=global_batcher)
            callbacks = build_callbacks(
                train_cfg.get("callbacks", {}).get(branch, []))
            branch_dir = ckpt_root / branch
            TrainingStatePersistence(branch_dir).restore_into(callbacks)
            evaluate = make_eval_fn(model, loss_name, dev, output_key)
            model.train()
            state, hist = _run_branch(
                branch, state, step_fn, batches, val_batches, epochs, steps,
                val_steps, branch_dir, callbacks, evaluate, generator,
                start_epoch=start_epochs[branch])
            model.eval()
            results.setdefault("programs", {})[branch] = dict(
                step_fn.program_counts)
            return hist

        # === PROJECTION (self-supervised ArcFace pretraining) ===
        proj_cfg = model_cfg.get("projection")
        proj_epochs = int(train_cfg.get("projection_epochs", 0) or 0)
        proj_dir = ckpt_root / "projection"
        if (proj_cfg and proj_epochs > 0 and self_supervised_pretraining
                and train_paths and converged(proj_dir) is None
                and not (only_reliability_head or only_save)):
            logger.info("training projection branch (ArcFace)")
            history["projection"] = _train_projection(
                model, proj_cfg, train_cfg, num_classes, reg_specs,
                lambda e: make_batches(train_paths, e), proj_epochs,
                int(steps_override or train_cfg.get("classifier_train_steps",
                                                    100)),
                dev, generator, torch.Generator().manual_seed(seed),
                global_batcher)
            write_convergence_marker(proj_dir, "projection",
                                     {"epochs": proj_epochs})

        # === CLASSIFIER ===
        cls_epochs = int(epochs_override if epochs_override is not None
                         else train_cfg.get("classifier_epochs", 1))
        cls_dir = ckpt_root / "classifier"
        if cls_epochs > 0 and train_paths and (
                converged(cls_dir) is None or epochs_override) and not (
                only_reliability_head or only_save):
            loss_name = train_cfg.get("loss_classifier",
                                      "categorical_crossentropy")
            tx = make_optimizer(
                train_cfg.get("optimizer", "adam"),
                train_cfg.get("optimizer_params", {}),
                accumulation_steps=int(train_cfg.get("accumulation_steps", 1)
                                       or 1))
            step_cfg = StepConfig(
                loss_name=loss_name,
                loss_params=train_cfg.get("loss_params_classifier", {}),
                class_weights=_class_weights(train_cfg,
                                             "classifier_class_weights",
                                             num_classes, dev),
                reg_specs=reg_specs,
                frozen_prefixes=(("embedding", "translated_embedding", "rep",
                                  "rep_branch", "projection")
                                 if only_classification_head else ()),
                heads=("prediction",))
            cls_hist = run(
                "classifier", step_cfg, tx,
                lambda e: make_batches(train_paths, e),
                (lambda: make_batches(val_paths, 999, repeat=False))
                if val_paths else None,
                cls_epochs,
                int(steps_override or train_cfg.get("classifier_train_steps",
                                                    100)),
                int(train_cfg.get("classifier_validation_steps", 10)),
                loss_name, "prediction")
            write_convergence_marker(cls_dir, "classifier", {
                "epochs": cls_epochs,
                "final": cls_hist[-1] if cls_hist else {}})
            history["classifier"] = cls_hist

        # === RELIABILITY ===
        rel_cfg = model_cfg.get("reliability_model")
        rel_epochs = int(train_cfg.get("reliability_epochs", 0) or 0)
        rel_dir = ckpt_root / "reliability"
        if generate_reliability is None:
            generate_reliability = bool(
                train_cfg.get("generate_reliability_data", False))
        rel_paths = _fragment_paths(train_cfg, "fragment_reliability_data")
        if rel_cfg and rel_epochs > 0 and not only_save:
            if generate_reliability:
                rel_paths = _generate_reliability(
                    model, train_cfg, train_paths, rel_paths, out_root,
                    crop_nt, id_threshold, synthetic_ood_threshold,
                    synthetic_ood_multiplier)
            rel_train = rel_paths.get("train", {}).get("paths", [])
            rel_val = rel_paths.get("validation", {}).get("paths", [])
            if start_epochs["reliability"] == 0:
                _apply_frequency_biases(config, model, train_paths, train_cfg,
                                        sp, reliability_paths=rel_train,
                                        branches=("reliability_model",))
            if rel_train:
                logger.info("training reliability branch (rep+classifier "
                            "frozen)")
                loss_name = train_cfg.get("loss_reliability",
                                          "binary_crossentropy")
                tx = make_optimizer(train_cfg.get("optimizer", "adam"),
                                    train_cfg.get("optimizer_params", {}))
                step_cfg = StepConfig(
                    loss_name=loss_name,
                    loss_params=train_cfg.get("loss_params_reliability", {}),
                    output_key="reliability",
                    frozen_prefixes=("embedding", "rep", "classifier",
                                     "projection"),
                    heads=("reliability",))

                def rel_batches(paths_, epoch_seed, repeat=True):
                    return data_lib.batches_from_csv(
                        paths_, batch_size=batch_size, crop_nt=crop_nt,
                        num_classes=1, seed=seed + epoch_seed, repeat=repeat,
                        label_map=_label_map(sp, "reliability"))

                rel_hist = run(
                    "reliability", step_cfg, tx,
                    lambda e: rel_batches(rel_train, e),
                    (lambda: rel_batches(rel_val, 999, repeat=False))
                    if rel_val else None,
                    rel_epochs,
                    int(steps_override or train_cfg.get(
                        "reliability_train_steps", 100)),
                    int(train_cfg.get("reliability_validation_steps", 10)),
                    loss_name, "reliability")
                write_convergence_marker(rel_dir, "reliability",
                                         {"epochs": rel_epochs})
                history["reliability"] = rel_hist
                if rel_val:
                    _tune_threshold(model, rel_val[0], crop_nt, batch_size,
                                    dev, rel_dir, results)

        results["history"] = history
        results["params"] = int(sum(p.numel() for p in model.parameters()))
        trained_this_run = bool(history) or any(start_epochs.values())
        if save and not mh.is_primary():
            # the other processes computed the same model; the export, the
            # int8 calibration and the metadata are the primary's to write
            results["model_path"] = str(out_root)
            return results
        if save:
            _export(model, config, train_cfg, out_root, trained_this_run,
                    history, results, dev)
            if meta:
                import json

                Path(meta).write_text(json.dumps(
                    {"model_path": str(out_root),
                     "experiment_path": str(Path(out_root).parent)}, indent=2))
        return results


def _train_projection(model, proj_cfg, train_cfg, num_classes, reg_specs,
                      make_train_batches, epochs, steps, device, generator,
                      init_generator, global_batcher=None) -> list[dict]:
    """The ArcFace pretraining of the projection head, as JAX's ``proj_step``:
    one optimizer over the model's parameters and the ArcFace
    ``class_weights`` (not exported), the training forward of the
    ``projection`` head alone (batch statistics updated), the ArcFace loss
    plus the model's regularization. Returns each epoch's last loss."""
    proj_dim = None
    for entry in reversed(proj_cfg.get("hidden_layers", [])):
        units = (entry.get("config") or {}).get("units")
        if units:
            proj_dim = int(units)
            break
    arcface = losses_lib.ArcFaceLoss(
        num_classes, proj_dim, margin=float(proj_cfg.get("margin", 0.5)),
        scale=float(proj_cfg.get("scale", 30.0)),
        generator=init_generator).to(device)
    tx = make_optimizer(train_cfg.get("optimizer", "adam"),
                        train_cfg.get("optimizer_params", {}))
    params = projection_params(model, arcface)
    opt_state = tx.init({k: p.detach() for k, p in params.items()})
    step = make_projection_step(model, arcface, tx, reg_specs)
    hist = []
    model.train()
    for epoch in range(epochs):
        loss = None
        for i, batch in enumerate(make_train_batches(epoch)):
            if i >= steps:
                break
            if global_batcher is not None:
                batch = global_batcher.shard(batch)
            opt_state, loss = step(opt_state, to_device(batch, device),
                                   generator)
        if loss is not None:
            hist.append({"epoch": epoch, "loss": float(loss)})
            logger.info(f"projection epoch {epoch}: loss={float(loss):.4f}")
    model.eval()
    return hist


def projection_params(model, arcface) -> dict[str, torch.nn.Parameter]:
    """The projection step's parameters by flax path: JAX's
    ``{"model": params, "arcface": arcface params}`` tree."""
    params = {f"model/{k}": p for k, p in flax_params(model).items()}
    params["arcface/class_weights"] = arcface.class_weights
    return params


def make_projection_step(model, arcface, tx, reg_specs=()):
    """``(opt_state, batch, generator) -> (opt_state, loss)``: one
    projection step on a device batch (``bases``/``lengths`` or
    ``translated``, one-hot ``labels``), updating the parameters and batch
    statistics in place; ``step.grads`` holds the last gradients (flax
    paths under ``model/`` and ``arcface/``). ``loss`` is the ArcFace loss
    without the regularization, as JAX's ``proj_step`` returns it."""
    def step(opt_state, batch, generator=None):
        params = projection_params(model, arcface)
        for p in params.values():
            p.requires_grad_(True)
        out = model(**model_inputs(batch), train=True,
                    heads=("projection",), generator=generator)
        loss = arcface(batch["labels"], out["projection"])
        reg = losses_lib.regularization_loss(flax_params(model),
                                             list(reg_specs))
        got = torch.autograd.grad(loss + reg, list(params.values()),
                                  allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else g.float())
                 for (k, p), g in zip(params.items(), got)}
        for p in params.values():
            p.requires_grad_(False)
        loss = loss.detach()
        if mh.is_distributed():
            # data parallel: the means over the processes, one buffer
            reduced = mh.all_reduce_mean({**grads, ("metric", "loss"): loss})
            loss = reduced.pop(("metric", "loss"))
            grads = reduced
        opt_state, _ = tx.apply(params, grads, opt_state)
        step.grads = grads
        return opt_state, loss

    step.grads = None
    return step


def _generate_reliability(model, train_cfg, train_paths, rel_paths,
                          out_root, crop_nt, id_threshold,
                          synthetic_ood_threshold, synthetic_ood_multiplier):
    """``--generate-reliability-data``: the knobs of
    ``training.reliability_data_generation`` (the arguments override
    its thresholds and multiplier) -> the generated reliability paths."""
    from jaeger_tpu_torch.dataops.reliability_generator import \
        generate_reliability_data

    gen_cfg = train_cfg.get("reliability_data_generation", {}) or {}
    raw_csvs = gen_cfg.get("raw_csv_paths") or {}
    raw_train = (raw_csvs.get("train")
                 or (train_paths[0] if train_paths else None)
                 or gen_cfg.get("raw_csv_path"))
    if not raw_train:
        raise ValueError(
            "--generate_reliability_data requires raw CSV sequences. Set "
            "reliability_data_generation.raw_csv_paths.train in the config "
            "or provide CSV classifier training data.")
    if rel_paths.get("train", {}).get("paths"):
        logger.warning("--generate_reliability_data is active; ignoring "
                       "fragment_reliability_data paths provided in the "
                       "config")

    def knob(arg, key, default):
        return float(arg if arg is not None else gen_cfg.get(key, default))

    gen_out = gen_cfg.get("output_dir") or str(out_root / "reliability_data")
    if mh.is_multiprocess() and not mh.is_primary():
        # generation is seeded, so every process makes the same data, but
        # only the primary writes the canonical directory
        gen_out = str(Path(gen_out).with_name(
            Path(gen_out).name + f".proc{mh.process_index()}"))
    return generate_reliability_data(
        model, raw_train, gen_out, crop_nt,
        id_threshold=knob(id_threshold, "id_threshold", 0.8),
        synthetic_ood_threshold=knob(synthetic_ood_threshold,
                                     "synthetic_ood_threshold", 0.8),
        synthetic_ood_multiplier=knob(synthetic_ood_multiplier,
                                      "synthetic_ood_multiplier", 1.0),
        batch_size=int(gen_cfg.get("inference_batch_size", 512)),
        perturbations=gen_cfg.get("perturbations"),
        val_fraction=float(gen_cfg.get("val_fraction", 0.1)),
        raw_val_csv_path=raw_csvs.get("val"),
        synthetic_source_sample_size=gen_cfg.get(
            "synthetic_source_sample_size"))


def _tune_threshold(model, csv_path, crop_nt, batch_size, device, rel_dir,
                    results) -> None:
    """Reliability threshold tuning and calibration on the validation
    CSV (sigmoid scores against the ID/OOD labels)."""
    scores, labels = collect_reliability_scores(model, csv_path, crop_nt,
                                                batch_size, device)
    if np.unique(labels).size < 2:
        return
    from jaeger_tpu_torch.postprocess.threshold import (
        calibration_summary, tune_reliability_threshold,
        write_calibration_outputs, write_threshold_outputs)

    best, rows, summary = tune_reliability_threshold(scores, labels)
    ece, _, cal_rows = calibration_summary(scores, labels)
    if mh.is_primary():
        write_threshold_outputs(rel_dir, best, rows)
        write_calibration_outputs(rel_dir, cal_rows)
    results["reliability_threshold"] = best
    results["reliability_auroc"] = summary["auroc"]
    logger.info(f"reliability threshold={best} auroc={summary['auroc']:.3f} "
                f"ece={ece:.3f}")


def _export(model, config, train_cfg, out_root: Path, trained_this_run,
            history, results, device) -> None:
    """The bundle, ``history.csv`` and the calibrated ``<out>/int8``."""
    if not trained_this_run and (out_root / "params.msgpack").exists():
        # every branch was convergence-skipped: the model holds fresh
        # init, which must not clobber the trained bundle
        results["model_path"] = str(out_root)
        logger.info("all branches already converged; existing model at "
                    f"{out_root} left untouched")
        return
    save_model(model.state_dict(), config, out_root)
    results["model_path"] = str(out_root)
    _write_history(out_root / "history.csv", history)
    logger.info(f"model saved to {out_root}")
    # a bundle from a previous run into this directory goes first either
    # way: `predict --int8` must never serve a stale quantization
    shutil.rmtree(out_root / "int8", ignore_errors=True)
    if train_cfg.get("model_saving", {}).get("save_int8", True):
        try:
            from jaeger_tpu_torch.models.conversion import quantize_bundle

            stats = quantize_bundle(out_root, out_root / "int8",
                                    mode="full_int8", device=device)
            results["int8_path"] = str(out_root / "int8")
            logger.info(f"calibrated full_int8 bundle saved to "
                        f"{out_root / 'int8'} "
                        f"({stats.get('int8_exec_convs', 0)} int8 convs)")
        except Exception as exc:  # quantization must never invalidate a
            # finished train; remove any partial bundle so --int8 errors
            shutil.rmtree(out_root / "int8", ignore_errors=True)
            logger.warning(f"int8 auto-calibration skipped: {exc}")


def _write_history(path: Path, history: dict) -> None:
    rows = [{"branch": branch, **row} for branch, hist in history.items()
            for row in hist]
    if not rows:
        return
    fields = ["branch"] + sorted({k for r in rows for k in r} - {"branch"},
                                 key=lambda k: (k != "epoch", k))
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)


def collect_reliability_scores(model, csv_path, crop_nt, batch_size, device):
    """Sigmoid reliability scores and ID/OOD labels over a CSV."""
    from jaeger_tpu_torch.seqops.windows import BASE_N, encode_ascii

    rows = []
    with open(csv_path) as fh:
        for line in fh:
            parts = line.strip().split(",")
            if len(parts) >= 2:
                try:
                    rows.append((int(parts[0]), parts[1]))
                except ValueError:
                    continue
    scores, labels = [], []
    with torch.inference_mode():
        for i in range(0, len(rows), batch_size):
            chunk = rows[i:i + batch_size]
            bases = np.full((batch_size, crop_nt), BASE_N, dtype=np.uint8)
            lengths = np.zeros(batch_size, dtype=np.int32)
            for j, (_, seq) in enumerate(chunk):
                ids = encode_ascii(seq[:crop_nt])
                bases[j, :ids.shape[0]] = ids
                lengths[j] = ids.shape[0]
            out = model(torch.from_numpy(bases).to(device),
                        torch.from_numpy(lengths).to(device))
            rel = out["reliability"].double().cpu().numpy()[:len(chunk)]
            scores.extend(1 / (1 + np.exp(-rel.reshape(-1))))
            labels.extend(lbl for lbl, _ in chunk)
    return np.asarray(scores), np.asarray(labels)
