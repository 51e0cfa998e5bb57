"""Training CLI with the reference's flag surface and on-disk outputs
(counterpart of the JAX package's cli/train_fit.py), for one device.

Same argparse flags (including the inverted-name store_false flags --NoLSTM /
--unidirectional / --positional_encoding / --batch_second / --write_results),
same experiment folder layout (`logs`, `checkpoints/`, `results.txt`,
`all_results.json`, `all_scores.json`, `*_fit_results.csv`), same encoder ->
dimension table, same serial hyper-parameter grid and fold orchestration, and
the same choice of the best configuration on the monitored validation loss.
Checkpoints are written in the JAX package's pickle format, which both
packages' predict CLIs read. `--device` picks the device (default `cuda`,
which raises without a card; `cpu` runs the same code on the CPU).

Every architecture name of the JAX registry trains, late fusion with its
second modality (`-arc BiLSTMLateFusion -enc2 <encoder> -ef2 <folder>`, the
same documents and unit counts as `-ef`) and SwitchBiLSTM with each
document's domain flag (a file name that starts with a digit is domain 1).

The single-device extensions run as in the JAX CLI: `--parallel_grid`
trains a dropout-only grid per fold through `GridTrainer` (train/grid.py;
an ineligible grid trains serially, with JAX's warning in `logs` and on
stderr),
`--device_epochs` runs the epoch loop's decisions on the device
(train/device_fit.py), `--pca_reduce` projects each fold on the principal
components of its training units (`apply_pca`, in torch on the run's
device), `--infer` tests `checkpoints/final=0.500.ckpt` of a finished
experiment, `--both_datasets` merges the sibling RadioNews/NonNews corpus and
`--zero_shot_labels` adds its labels to results.txt.

Parallel runs (parallel/*): under `torchrun` (WORLD_SIZE > 1) every rank runs
this CLI over the same folds, as JAX runs it over more than one device:
`--pipeline_stages S` pipelines a Transformer's layers over S ranks,
`--sequence_shards N` shards its units over N, `--expert_parallel on` runs
SwitchBiLSTM's two towers one per rank (auto for `--switch lstm` on two
ranks or more), and otherwise the training steps are data-parallel over
all ranks (a `-pg` grid spreads its configurations over them). JAX's
up-front checks and messages are kept; rank 0 writes every file
(`logs`, checkpoints, `results.txt`, the JSON and CSV files) and the
other ranks wait for it where they read one. `--device_epochs` runs the
single-device loop and takes one rank.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import sys

import numpy as np
import torch

from ..core.torch_setup import resolve_device
from ..models import registry
from ..models.base import TaggerConfig
from ..train import checkpoints as ckpt_lib
from ..train.data import add_dataset, batches, load_dataset_from_precomputed
from ..train.loop import Trainer
from ..utils import profiling

EMBEDDING_SIZES = {
    "prosodic": 167,
    "openl3_std": 1024,
    "openl3/_mean_std": 1024,
    "wav2vec_std": 1536,
    "wav2vec/_mean_std": 1536,
    "x-vectors": 512,
    "openl3": 512,
    "crepe_std": 512,
    "crepe/mean_std": 512,
    "crepe": 256,
    "mfcc": 200,
    "ecapa": 192,
    "wav2vec": 768,
    "radio_news_topseg": 768,
    "non_news_topseg": 768,
    "radio_news_roberta": 768,
    "non_news_roberta": 768,
    "CNN": 30,
}

def _writing() -> bool:
    """Whether this process writes the experiment's files: rank 0, or alone."""
    from ..parallel.mesh import global_rank

    return global_rank() == 0


def _log(text: str, mode: str = "a"):
    """Append `text` to the experiment's `logs` (rank 0 only)."""
    if _writing():
        with open("logs", mode) as f:
            f.write(text)


def _resolve_monitored(val_loss: float) -> float:
    """`parse_checkpoint_name` gives NaN for a `final=` checkpoint, whose name
    carries no monitored loss; selection still needs a number, so fall back
    to the reference's 0.5 and say so in the logs."""
    if np.isnan(val_loss):
        _log("Monitored loss synthesized: final= checkpoint carries no "
             "val loss; using 0.5 for config selection\n")
        return 0.5
    return val_loss


def infer_embedding_dim(encoder: str, encoder2=None, timing_file=None, pca=False,
                        pca_value=167):
    """The reference's dimension inference, '+' early-fusion sums included;
    with `encoder2`, [dim, dim2]; with `pca`, `pca_value` alone. A timing
    file adds 2 to each."""

    def one(enc_string):
        if re.findall("sentence", enc_string.lower()):
            encs = ["/".join(e.split("/")[1:]) for e in enc_string.split("+")]
        else:
            encs = enc_string.split("+")
        try:
            return sum(EMBEDDING_SIZES[e] for e in encs)
        except KeyError:
            raise ValueError("Encoder not recognised, use one of the available options "
                             "(x-vectors, openl3, mfcc, prosodic, CREPE, ecapa or wav2vec)")

    extra = 2 if timing_file is not None else 0
    if pca:
        return pca_value + extra
    if encoder2 is not None:
        return [one(encoder) + extra, one(encoder2) + extra]
    return one(encoder) + extra


def data_width(folds):
    """The width of the loaded embeddings, timing columns included (the first
    document's), or None when no fold holds a document."""
    for fold in folds:
        for docs in fold:
            if docs:
                return int(np.shape(docs[0][0])[-1])
    return None


def apply_pca(train_docs, other_doc_lists, n_components: int, device="cpu"):
    """PCA fit on the concatenated training units and applied to them and to
    each list of `other_doc_lists` (valid, test) with the training mean, as
    the JAX CLI's sklearn PCA: centred, float64, components from
    `torch.linalg.eigh` of the covariance in decreasing variance, each
    component's largest-magnitude entry made positive (sklearn's sign rule),
    float32 out. -> (projected train docs, [projected docs per list])."""
    x = torch.from_numpy(np.concatenate([d[0] for d in train_docs], axis=0))
    x = x.to(device=device, dtype=torch.float64)
    mean = x.mean(0)
    xc = x - mean
    _, vecs = torch.linalg.eigh(xc.T @ xc / max(len(xc) - 1, 1))
    components = vecs.flip(-1)[:, :n_components].T  # [k, dim], decreasing variance
    rows = torch.arange(len(components), device=components.device)
    signs = torch.sign(components[rows, components.abs().argmax(1)])
    components = components * signs[:, None]

    def project(docs):
        out = []
        for emb, lab, name in docs:
            e = torch.from_numpy(np.asarray(emb)).to(device=device, dtype=torch.float64)
            out.append((((e - mean) @ components.T).float().cpu().numpy(), lab, name))
        return out

    return project(train_docs), [project(docs) for docs in other_doc_lists]


def _write_grid_csv(path: str, grid: dict):
    """{layers: [value per configuration]} as pandas' DataFrame.to_csv writes it."""
    cols = list(grid)
    with open(path, "w") as f:
        f.write("," + ",".join(str(c) for c in cols) + "\n")
        for i in range(max((len(grid[c]) for c in cols), default=0)):
            f.write(",".join([str(i)] + [str(grid[c][i]) for c in cols]) + "\n")


def _parallel_plan(args, n_dev: int):
    """The run's parallel mode, with the JAX CLI's up-front checks, made
    before the experiment folder exists and any fold trains: -> (mesh,
    pipeline_stages, sequence_shards, expert_parallel). With more than one
    rank the steps are data-parallel over all of them (the -pg grid's
    configurations too) unless the pipeline, the sequence shards or the
    expert towers own the ranks, as the JAX CLI builds its mesh."""
    from ..parallel import mesh as mesh_lib

    mesh = None
    pipeline_stages = int(args.pipeline_stages or 0)
    sequence_shards = int(args.sequence_shards or 0)
    expert_parallel = {"auto": None, "on": True, "off": False}[args.expert_parallel]
    if args.device_epochs:
        # the device windows run the plain single-device step
        if pipeline_stages > 1 or sequence_shards > 1 or expert_parallel is True:
            raise SystemExit("--device_epochs is exclusive with --pipeline_stages/"
                             "--sequence_shards/--expert_parallel on")
        if n_dev > 1:
            raise SystemExit(f"--device_epochs runs the single-device loop: start one rank, "
                             f"have {n_dev}")
        expert_parallel = False
    elif pipeline_stages > 1 or sequence_shards > 1:
        pass  # the pipeline / sequence shards own the ranks
    elif (expert_parallel is None and args.architecture == "SwitchBiLSTM"
          and args.switch == "lstm" and n_dev >= 2):
        # mesh stays None so that the Trainer's expert-parallel auto-enable fires
        print("[train_fit] auto-enabling expert parallelism for SwitchBiLSTM switch=lstm "
              "(pass --expert_parallel off for data parallelism)", file=sys.stderr)
    elif n_dev > 1:
        mesh = mesh_lib.make_mesh(model_parallel=1)

    if pipeline_stages > 1:
        if args.architecture != "Transformer":
            raise SystemExit(f"--pipeline_stages applies to -a Transformer, "
                             f"not {args.architecture!r}")
        if n_dev < pipeline_stages:
            raise SystemExit(f"--pipeline_stages {pipeline_stages} needs that many devices, "
                             f"have {n_dev}")
        layer_counts = ((args.hyperparameters_search and args.number_layers_search_space)
                        or [args.num_layers])
        bad_nl = [nl for nl in layer_counts if nl % pipeline_stages != 0]
        if bad_nl:
            raise SystemExit(f"--pipeline_stages {pipeline_stages} does not divide the "
                             f"layer count(s) {bad_nl} in the search space")
    if sequence_shards > 1:
        if pipeline_stages > 1:
            raise SystemExit("--sequence_shards and --pipeline_stages are exclusive")
        if args.architecture != "Transformer":
            raise SystemExit(f"--sequence_shards applies to -a Transformer (local "
                             f"attention), not {args.architecture!r}")
        if not args.self_attention_window:
            raise SystemExit("--sequence_shards needs local attention: set -window/"
                             "--self_attention_window")
        if n_dev < sequence_shards:
            raise SystemExit(f"--sequence_shards {sequence_shards} needs that many devices, "
                             f"have {n_dev}")
    if expert_parallel is True:
        if args.architecture != "SwitchBiLSTM" or args.switch != "lstm":
            raise SystemExit("--expert_parallel on applies to -a SwitchBiLSTM with "
                             "--switch lstm (twin LSTM towers)")
        if n_dev < 2:
            raise SystemExit(f"--expert_parallel on needs 2 devices, have {n_dev}")
    return mesh, pipeline_stages, sequence_shards, expert_parallel


def main(args):
    from ..parallel import mesh as mesh_lib

    n_dev = mesh_lib.world_size()
    device = mesh_lib.rank_device(args.device) if n_dev > 1 else resolve_device(args.device)
    # an unknown architecture fails here, before the experiment folder exists
    registry.build(args.architecture, TaggerConfig(embedding_dim=8, embedding_dim2=8, hidden_dim=8,
                                                   num_layers=1, nheads=2, attention_window=4))
    mesh, pipeline_stages, sequence_shards, expert_parallel = _parallel_plan(args, n_dev)

    if args.infer:
        assert os.path.exists(args.experiment_name), (
            "If using pre-trained model to infer only, the given folder must "
            "exist and include the checkpoint subfolder with trained weights")
    else:
        assert not os.path.exists(args.experiment_name), (
            "The name of this experiment has already been used: please change "
            "experiment name or delete {} to use this name".format(args.experiment_name))
        mesh_lib.barrier()  # every rank has looked before rank 0 makes it
        if _writing():
            os.makedirs(args.experiment_name)
        mesh_lib.barrier()

    test = args.dataset == "BBC" or args.standard_split is not None
    folds = load_dataset_from_precomputed(
        args.embedding_folder,
        args.lab_folder,
        delete_last_sentence=args.delete_last_sentence,
        k_folds=args.k_folds,
        mask_inner_sentences=args.mask_inner_sentences,
        mask_probability=args.mask_probability,
        split=args.standard_split,
        timing_info=args.timing_file,
    )
    double = registry.is_double_input(args.architecture)
    if double:
        # the second modality: the same documents, labels and folds
        folds2 = load_dataset_from_precomputed(
            args.embedding_folder2,
            args.lab_folder,
            delete_last_sentence=args.delete_last_sentence,
            k_folds=args.k_folds,
            mask_inner_sentences=args.mask_inner_sentences,
            mask_probability=args.mask_probability,
            split=args.standard_split,
        )
        if args.both_datasets:
            folds2 = add_dataset(args, folds2, fold2=True)
    if args.both_datasets:
        folds = add_dataset(args, folds)
    val_folder = args.standard_split is not None
    os.chdir(args.experiment_name)

    CRF = registry.is_crf(args.architecture)
    domain_adapt = registry.is_domain_adapt(args.architecture)

    if args.architecture in ("Transformer", "BiLSTMRestrictedMHA", "RecurrentLongformer"):
        truncate, tv = True, 3600  # the reference's fixed unit budget for these
    else:
        truncate, tv = False, 100

    # assemble per-fold batch lists
    def split_fold(fold):
        valid_split = int(len(fold[0]) * args.valid_percentage)
        if args.no_validation or val_folder:
            valid = fold[2] if (val_folder and not args.no_validation) else None
            return fold[0], valid, fold[1]
        return fold[0][:-valid_split], fold[0][-valid_split:], fold[1]

    def make_batches(docs, docs2, bs):
        if not docs:
            return None
        bl = list(batches(docs, max(bs, 1), crf=CRF, truncate=truncate, truncate_value=tv,
                          domain_adapt=domain_adapt))
        if docs2 is not None:
            # the second modality's batches, padded alike, ride along
            bl2 = batches(docs2, max(bs, 1), crf=CRF, truncate=truncate, truncate_value=tv)
            for b, b2 in zip(bl, bl2):
                b["src_tokens2"] = b2["src_tokens"]
        return bl

    fold_loaders = []
    for index, fold in enumerate(folds):
        train_docs, valid_docs, test_docs = split_fold(fold)
        train2, valid2, test2 = split_fold(folds2[index]) if double else (None, None, None)
        if args.pca_reduce:
            others = [d for d in (valid_docs, test_docs) if d is not None]
            train_docs, projected = apply_pca(train_docs, others, args.pca_value, device)
            projected = iter(projected)
            if valid_docs is not None:
                valid_docs = next(projected)
            test_docs = next(projected)
        bs = args.batch_size
        test_batches = make_batches(test_docs, test2, 1)
        if not test_batches:
            raise ValueError("There is something wrong with the test loader...")
        fold_loaders.append((
            make_batches(train_docs, train2, min(bs, len(train_docs))),
            make_batches(valid_docs, valid2, min(bs, len(valid_docs)) if valid_docs else bs),
            test_batches,
            fold,
        ))

    np.random.seed(int(args.seed))

    # hyperparameter grid (works with or without -hs)
    search_space = {
        "hidden_units": [args.hidden_units],
        "number_layers": [args.num_layers],
        "dropin": [args.dropout_in],
        "dropout": [args.dropout_out],
    }
    if args.hyperparameters_search:
        if args.hidden_units_search_space:
            search_space["hidden_units"] = args.hidden_units_search_space
        if args.number_layers_search_space:
            search_space["number_layers"] = args.number_layers_search_space
        if args.dropout_in_search_space:
            search_space["dropin"] = args.dropout_in_search_space
        if args.dropout_out_search_space:
            search_space["dropout"] = args.dropout_out_search_space
    hyperparameters = list(itertools.product(
        search_space["hidden_units"], search_space["number_layers"],
        search_space["dropin"], search_space["dropout"]))

    results_grid_f1 = {nl: [] for nl in search_space["number_layers"]}
    results_grid_pk = {nl: [] for nl in search_space["number_layers"]}
    results_grid_wd = {nl: [] for nl in search_space["number_layers"]}

    _log("Training started all right...\n", mode="w")

    embedding_dim = infer_embedding_dim(args.encoder, args.encoder2 if double else None,
                                        args.timing_file, args.pca_reduce, args.pca_value)
    emb_dim, emb_dim2 = embedding_dim if isinstance(embedding_dim, list) else (embedding_dim, 0)
    if not args.pca_reduce:
        # the embeddings' own width wins over the encoder name's: a `wav2vec`
        # folder of WavLM-Large frames is 1024 wide, not 768
        emb_dim = data_width(folds) or emb_dim
        if double:
            emb_dim2 = data_width(folds2) or emb_dim2

    monitor = "training_loss" if args.no_validation else "val_loss"
    best_results = {"F1": 0, "Pk": 1, "WD": 1}
    if args.metric.lower() == "b":
        best_results["B"] = 0
    best_results_val = (
        float("inf") if args.metric in ("WD", "Pk") or not args.search_threshold else 0)
    best_hu = best_nl = best_dropin = best_dropout = None
    confidence = {}

    def tagger_config(hu, nl, d_in, d_out):
        return TaggerConfig(
            embedding_dim=emb_dim,
            embedding_dim2=emb_dim2,
            hidden_dim=hu,
            num_layers=nl,
            tagset_size=2,
            bidirectional=args.unidirectional,  # store_false flag (reference quirk)
            lstm=args.NoLSTM,  # store_false flag
            dropout_in=d_in,
            dropout_out=d_out,
            loss_fn=args.loss_function,
            nheads=args.number_heads,
            attention_window=args.self_attention_window,
            positional_encoding=args.positional_encoding,
            switch=args.switch,
            cosine_loss=args.cosine_loss,
        )

    # --parallel_grid: every dropout configuration of a fold through one
    # GridTrainer (train/grid.py), where the grid varies dropout only; the
    # warnings are the JAX CLI's
    pregrid = {}
    if args.parallel_grid and not args.infer:
        from ..train.grid import GridTrainer

        why = None
        if args.architecture not in GridTrainer.SUPPORTED:
            why = (f"architecture {args.architecture!r} is not lockstep-eligible "
                   f"(supported: {', '.join(GridTrainer.SUPPORTED)})")
        elif len(search_space["hidden_units"]) > 1 or len(search_space["number_layers"]) > 1:
            why = ("the grid varies hidden_units/number_layers (parameter shapes "
                   "differ across configs; only dropout-only grids run lockstep)")
        elif len(hyperparameters) <= 1:
            why = "the grid has a single configuration (nothing to batch)"
        if why is not None:
            msg = f"--parallel_grid ignored: {why}; training serially."
            print(f"WARNING: {msg}", file=sys.stderr)
            _log(msg + "\n")
        else:
            grid_rates = [(d_in, d_out) for _hu, _nl, d_in, d_out in hyperparameters]
            hu0, nl0 = search_space["hidden_units"][0], search_space["number_layers"][0]
            for index, (train_loader, valid_loader, _test, _fold) in enumerate(fold_loaders):
                check_dir = "checkpoints" + (f"_{index}" if args.save_all_checkpoints else "")
                os.makedirs(check_dir, exist_ok=True)
                gt = GridTrainer(
                    args.architecture, tagger_config(hu0, nl0, 0.0, 0.0), grid_rates,
                    lr=args.learning_rate, optimizer=args.optimizer, max_epochs=args.max_epochs,
                    patience=args.patience, no_early_stop=args.no_early_stop, monitor=monitor,
                    check_dir=check_dir, seed=int(args.seed),
                    gradient_clipping=args.gradient_clipping,
                    tag=f"f{index}",  # folds may share check_dir; keep their checkpoints apart
                    mesh=mesh, device=device)
                with profiling.span("fit_grid"):
                    gt.fit(train_loader, None if args.no_validation else valid_loader)
                for gi, pt in enumerate(hyperparameters):
                    best_path = gt.best_model_paths[gi]
                    th, bvl = ckpt_lib.parse_checkpoint_name(best_path)
                    bvl = _resolve_monitored(bvl)
                    if args.no_validation or args.save_last_epoch:
                        best_path = gt.save_final(gi)
                    pregrid[(pt, index)] = (best_path, th, bvl)

    for param_tuple in hyperparameters:
        hu, nl, d_in, d_out = param_tuple
        if args.hyperparameters_search:
            _log("Results for model with {} hidden units, {} layers, {} dropout in, "
                 "{} dropout out and {} batch size...\n".format(hu, nl, d_in, d_out,
                                                                args.batch_size))

        fold_results = []
        fold_all_results, fold_all_scores = {}, {}
        for index, (train_loader, valid_loader, test_loader, fold) in enumerate(fold_loaders):
            check_dir = "checkpoints" + (f"_{index}" if args.save_all_checkpoints else "")
            os.makedirs(check_dir, exist_ok=True)

            trainer = Trainer(
                architecture=args.architecture,
                cfg=tagger_config(hu, nl, d_in, d_out),
                lr=args.learning_rate,
                optimizer=args.optimizer,
                max_epochs=args.max_epochs,
                patience=args.patience,
                no_early_stop=args.no_early_stop,
                monitor=monitor,
                check_dir=check_dir,
                seed=int(args.seed),
                gradient_clipping=args.gradient_clipping,
                metric=args.metric,
                use_end_boundary=args.use_end_boundary,
                zero_baseline=args.zero_baseline,
                device_epochs=args.device_epochs or None,
                mesh=mesh,
                pipeline_stages=pipeline_stages,
                sequence_shards=sequence_shards,
                expert_parallel=expert_parallel,
                device=device,
            )

            final_params = None
            if args.infer:
                # a finished experiment's last weights, at the reference's threshold
                trainer.best_model_path = os.path.join(check_dir, "final=0.500.ckpt")
                threshold = best_val_loss = 0.5
            elif (param_tuple, index) in pregrid:
                # this configuration already trained in the GridTrainer
                trainer.best_model_path, parsed_th, best_val_loss = pregrid[(param_tuple, index)]
                threshold = args.threshold if args.threshold else parsed_th
                if args.threshold:
                    best_val_loss = args.threshold
            else:
                with profiling.device_trace():
                    final_params, _ = trainer.fit(train_loader,
                                                  None if args.no_validation else valid_loader)
                parsed_th, parsed_loss = ckpt_lib.parse_checkpoint_name(trainer.best_model_path)
                threshold = args.threshold if args.threshold else parsed_th
                best_val_loss = args.threshold if args.threshold else _resolve_monitored(parsed_loss)
            if not args.infer and args.search_threshold and valid_loader and not args.no_validation:
                # pick the threshold on the validation documents; the
                # configuration is then chosen on the searched metric itself
                ckpt_params, _, _, _ = ckpt_lib.load(trainer.best_model_path)
                threshold, sth_val = trainer.search_threshold(ckpt_params, valid_loader)
                _log(f"Threshold search: best={threshold} ({args.metric}={sth_val:.4f})\n")
                best_val_loss = sth_val
            if final_params is not None and (args.no_validation or args.save_last_epoch):
                trainer.save_final(final_params)

            params, _, _, _ = ckpt_lib.load(trainer.best_model_path)
            # the reference always passes the (file-name or explicit) threshold
            trainer.threshold = threshold
            with profiling.span("test"):
                res, per_doc, scores = trainer.test(params, test_loader)
            fold_results.append(res)

            if args.metric.lower() in ("b", "scaiano"):
                pk_label, wd_label, f1_label = "b_precision", "b_recall", "b_f1"
                if args.metric.lower() == "scaiano":
                    f1_label = "test_loss"
            elif args.metric == "F1":
                f1_label, pk_label, wd_label = "test_loss", "Pk_loss", "WD_loss"
            elif args.metric == "WD":
                f1_label, pk_label, wd_label = "F1_loss", "Pk_loss", "test_loss"
            else:
                f1_label, pk_label, wd_label = "F1_loss", "test_loss", "WD_loss"

            lines = ["Results for fold number {}\n".format(index)]
            if args.metric.lower() in ("b", "scaiano"):
                lines += ["B_precision score: {}\n".format(res[pk_label]),
                          "B_recall score: {}\n".format(res[wd_label]),
                          "B_F1 score: {}\n".format(res[f1_label])]
                if args.metric.lower() == "b":
                    lines.append("B Similarity score: {}\n".format(res["test_loss"]))
            else:
                lines += ["PK score: {}\n".format(res[pk_label]),
                          "WD score: {}\n".format(res[wd_label]),
                          "F1 score: {}\n".format(res[f1_label])]
            _log("".join(lines))

            if args.all_results:
                for di, file in enumerate(fold[1]):
                    d = dict(per_doc[di])
                    if "test_loss" in d:
                        d[args.metric] = d.pop("test_loss")
                    fold_all_results[file[2]] = d
            if args.all_scores:
                for si, file in enumerate(fold[1]):
                    fold_all_scores[file[2]] = scores[si].tolist()

        # ---- best-configuration bookkeeping ----------------------------------
        pick = (lambda label: fold_results[-1][label] if test
                else float(np.mean([r[label] for r in fold_results])))
        f1, pk, wd = pick(f1_label), pick(pk_label), pick(wd_label)
        metrics_now = {"F1": f1, "Pk": pk, "WD": wd}
        if args.metric.lower() == "b":
            metrics_now["B"] = pick("test_loss")
        if args.hyperparameters_search:
            results_grid_f1[nl].append(f1)
            results_grid_pk[nl].append(pk)
            results_grid_wd[nl].append(wd)

        # with -sth on a maximised metric (F1 / b / scaiano) the selection
        # runs on the searched metric and must maximise
        maximize_sel = args.search_threshold and args.metric not in ("Pk", "WD")
        # under --infer every configuration is tested and the last one reported
        is_best = args.infer or (best_val_loss > best_results_val if maximize_sel
                                 else best_val_loss < best_results_val)
        if is_best:
            best_results = metrics_now
            if not args.infer:
                best_results_val = best_val_loss
            best_hu, best_nl, best_dropin, best_dropout = hu, nl, d_in, d_out
            if args.all_results and _writing():
                with open("all_results.json", "w") as f:
                    json.dump(fold_all_results, f)
            if args.all_scores and _writing():
                with open("all_scores.json", "w") as f:
                    json.dump(fold_all_scores, f)
            if not args.infer:
                best_name = os.path.join(check_dir, "best_model")
                mesh_lib.barrier()  # every rank has read the checkpoint
                if _writing():
                    if os.path.exists(best_name):
                        os.remove(best_name)
                    os.rename(trainer.best_model_path, best_name)
                mesh_lib.barrier()

            if not test:
                # cross-validation: bootstrap confidence intervals over folds
                def bootstrap_ci(values, samples=10000):
                    values = np.asarray(values, np.float64)
                    rng_ = np.random.default_rng(0)
                    boots = rng_.choice(values, size=(samples, len(values)),
                                        replace=True).mean(axis=1)
                    return (np.percentile(boots, 97.5) - np.percentile(boots, 2.5)) / 2

                confidence = {
                    "Pk": bootstrap_ci([r[pk_label] for r in fold_results]),
                    "F1": bootstrap_ci([r[f1_label] for r in fold_results]),
                    "WD": bootstrap_ci([r[wd_label] for r in fold_results]),
                }
                if args.metric.lower() == "b":
                    confidence["B"] = bootstrap_ci([r["test_loss"] for r in fold_results])

    if args.metric.lower() in ("b", "scaiano"):
        label_map = {"Pk": "Precision", "WD": "Recall", "F1": "F1"}
    else:
        label_map = {"Pk": "Pk", "WD": "WD", "F1": "F1"}

    output = [
        "Results for experiment {} with following parameters:".format(args.experiment_name),
        "Sentence encoder: {}".format(args.encoder),
        # the second modality, which predict reads back for late fusion
        *(["Second sentence encoder: {}".format(args.encoder2)] if double else []),
        "Neural architecture: {}".format(args.architecture),
        "Batch size: {}".format(args.batch_size),
        "Hidden units: {}".format(best_hu),
        "Dropout in: {}".format(best_dropin),
        "Dropout out: {}".format(best_dropout),
        "Number of layers: {}".format(best_nl),
        "Optimizer: {}".format(args.optimizer),
    ]
    if test:
        output += [
            "Mean {} obtained is {}".format(label_map["Pk"], best_results["Pk"]),
            "Mean F1 obtained is {}".format(best_results["F1"]),
            "Mean {} obtained is {}".format(label_map["WD"], best_results["WD"]),
        ]
        if args.metric.lower() == "b":
            output.append("Mean Boundary Similarity obtained is {}".format(best_results["B"]))
    else:
        ci = "Mean {} obtained is {} with a 95% confidence interval of +- {}"
        output += [
            ci.format(label_map["Pk"], best_results["Pk"], confidence["Pk"]),
            ci.format("F1", best_results["F1"], confidence["F1"]),
            ci.format(label_map["WD"], best_results["WD"], confidence["WD"]),
        ]
        if args.metric.lower() == "b":
            output.append(ci.format("Boundary Similarity", best_results["B"], confidence["B"]))

    if args.zero_shot_labels is not None:
        output.append("Labels: " + str(args.zero_shot_labels))

    if args.write_results and _writing():
        with open("results.txt", "w") as f:
            for line in output:
                f.write("\n" + line + "\n")
    profiling.maybe_print_report()

    if args.hyperparameters_search:
        grids = (results_grid_f1, results_grid_pk, results_grid_wd)
        if args.write_results and _writing():
            for name, grid in zip(("F1", "Pk", "WD"), grids):
                _write_grid_csv(f"{name}_fit_results.csv", grid)
        return output, grids
    return output


class MyParser(argparse.ArgumentParser):
    def error(self, message):
        sys.stderr.write("error: %s\n" % message)
        self.print_help()
        sys.exit(2)


def build_parser() -> argparse.ArgumentParser:
    parser = MyParser(description="Train and test a topic-segmentation tagger on precomputed "
                                  "embeddings")
    parser.add_argument("--experiment_name", "-exp", default="new_experiment", type=str)
    parser.add_argument("--dataset", "-data", default="choi", type=str)
    parser.add_argument("--batch_size", "-bs", default=64, type=int)
    parser.add_argument("--learning_rate", "-lr", default=0.01, type=float)
    parser.add_argument("--valid_percentage", "-vp", default=0.1, type=float)
    parser.add_argument("--encoder", "-enc", default="stsb-bert-base", type=str)
    parser.add_argument("--encoder2", "-enc2", default=None, type=str)
    parser.add_argument("--online_encoding", "-oe", action="store_true")
    parser.add_argument("--patience", "-pat", default=20, type=int)
    parser.add_argument("--architecture", "-arc", default="biLSTMCRF", type=str)
    parser.add_argument("--hidden_units", "-hu", default=25, type=int)
    parser.add_argument("--num_layers", "-nl", default=1, type=int)
    parser.add_argument("--NoLSTM", action="store_false")
    parser.add_argument("--number_heads", "-nh", default=8, type=int)
    parser.add_argument("--positional_encoding", "-pe", action="store_false")
    parser.add_argument("--threshold", "-th", default=0.0, type=float)
    parser.add_argument("--unidirectional", action="store_false")
    parser.add_argument("--max_length", type=int, required=False)
    parser.add_argument("--dropout_in", "-d_in", default=0.0, type=float)
    parser.add_argument("--dropout_out", "-d_out", default=0.0, type=float)
    parser.add_argument("--batch_second", action="store_false")
    parser.add_argument("--optimizer", "-opt", default="Adam", type=str)
    parser.add_argument("--max_epochs", "-max", default=100, type=int)
    parser.add_argument("--num_gpus", "-gpus", default=1, type=int)
    parser.add_argument("--auto_lr_finder", "-auto_lr", action="store_true")
    parser.add_argument("--save_all_checkpoints", "-savec", action="store_true")
    parser.add_argument("--save_embeddings", "-savee", action="store_true")
    parser.add_argument("--use_end_boundary", "-ueb", action="store_true")
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--write_results", "-wr", action="store_false")
    parser.add_argument("--hyperparameters_search", "-hs", action="store_true")
    # a dropout-only grid through one GridTrainer per fold (train/grid.py)
    parser.add_argument("--parallel_grid", "-pg", action="store_true")
    # the parallel modes, over the ranks of a torchrun start (parallel/*)
    parser.add_argument("--pipeline_stages", "-pps", type=int, default=0)
    parser.add_argument("--sequence_shards", "-sqs", type=int, default=0)
    parser.add_argument("--expert_parallel", default="auto", choices=["auto", "on", "off"])
    # the epoch loop's decisions on the device, one pull per window (train/device_fit.py)
    parser.add_argument("--device_epochs", "-de", action="store_true")
    parser.add_argument("--switch", default="dense", choices=["dense", "lstm"])
    parser.add_argument("--hidden_units_search_space", "-huss", nargs="*", type=int)
    parser.add_argument("--number_layers_search_space", "-nlss", nargs="*", type=int)
    parser.add_argument("--dropout_in_search_space", "-diss", nargs="*", type=float)
    parser.add_argument("--dropout_out_search_space", "-doss", nargs="*", type=float)
    parser.add_argument("--batch_size_search_space", "-bass", nargs="*", type=int)
    parser.add_argument("--metric", default="Pk", type=str,
                        choices=["Pk", "F1", "WD", "b", "scaiano"])
    parser.add_argument("--delete_last_sentence", "-dls", action="store_true")
    parser.add_argument("--zero_shot_labels", "-zsl", type=str, nargs="*")
    parser.add_argument("--search_threshold", "-sth", action="store_true")
    parser.add_argument("--cosine_loss", "-cos", action="store_true")
    parser.add_argument("--gradient_clipping", "-gc", default=0.0, type=float)
    parser.add_argument("--embedding_folder", "-ef", type=str, required=True)
    parser.add_argument("--embedding_folder2", "-ef2", type=str, default=None)
    parser.add_argument("--lab_folder", "-lf", type=str, required=True)
    parser.add_argument("--inverse_augment", "-ia", action="store_true")
    parser.add_argument("--zero_baseline", "-zb", action="store_true")
    parser.add_argument("--loss_function", "-loss",
                        choices=["CrossEntropy", "BinaryCrossEntropy", "FocalLoss"],
                        default="CrossEntropy")
    parser.add_argument("--seed", default=42)
    parser.add_argument("--no_validation", "-no_val", action="store_true")
    parser.add_argument("--no_early_stop", "-no_stop", action="store_true")
    parser.add_argument("--save_last_epoch", "-s_last", action="store_true")
    parser.add_argument("--pca_reduce", "-pca", action="store_true")
    parser.add_argument("--pca_value", "-pca_v", default=167, type=int)
    parser.add_argument("--all_results", "-ar", action="store_true")
    parser.add_argument("--all_scores", "-as", action="store_true")
    parser.add_argument("--k_folds", "-kcv", default=5, type=int)
    parser.add_argument("--mask_inner_sentences", "-msk", action="store_true")
    parser.add_argument("--mask_probability", "-msk_pr", default=0.9, type=float)
    parser.add_argument("--standard_split", "-split", type=str)
    parser.add_argument("--self_attention_window", "-window", default=120, type=int)
    parser.add_argument("--both_datasets", "-bd", action="store_true")
    parser.add_argument("--infer", action="store_true")
    parser.add_argument("--timing_file", required=False, type=str)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def cli_main(argv=None):
    """Parse and run; under torchrun (WORLD_SIZE > 1) this process joins the
    ranks' group first and leaves it at the end."""
    from ..parallel.multihost import process_group_from_environment

    args = build_parser().parse_args(argv)
    with process_group_from_environment(args.device):
        return main(args)


if __name__ == "__main__":
    cli_main()
