"""NTU RGB+D entry points: the bilevel search, found retraining and
test-only.

Port of ``bmnas_tpu/cli/ntu.py`` (parse_search_args, parse_found_args,
counts_fn, run_search, run_found, main_search, main_found). Both run on
CUDA unless ``--device cpu`` is given, and raise when there is no CUDA
device:

    python -m bmnas_tpu_torch.cli.ntu --datadir <root> [--device cpu]
    python -m bmnas_tpu_torch.cli.ntu_found --search_exp_dir <exp> \\
        --datadir <root> [--remat] [--task_variant ...] [--device cpu]
    python -m bmnas_tpu_torch.cli.ntu_found --eval_exp_dir <eval exp> \\
        --datadir <root> [--device cpu]

The defaults are the reference's, which differ between the two: the search
takes steps 2, 30 epochs, eta_max 1e-3 and Ti 1, found retraining steps 4,
50 epochs, eta_max 3e-4 and Ti 5; both C=128, L=8, node_steps 2,
node_multiplier 2, 8 inputs, 60 classes, batch 96 and ``--vid_len 8 32``.

The search reads the splits ``train_exp`` (with the random temporal crop)
and ``dev`` and writes ``final_exp/ntu/search-<save>-<timestamp>/``; found
retraining reads ``train_val`` (cropped) and ``test`` and writes
``<search exp>/eval-<save>-<timestamp>/``; test-only writes
``<eval exp>/test-<save>-<timestamp>/log.txt``. The files are those of the
MM-IMDB CLIs (``cli/mmimdb.py``), with accuracy for the metric.

Pretrained backbones (``--checkpointdir`` with ``--ske_cp``, ``--rgb_cp``,
``--imagenet_cp``) are not imported yet: a checkpoint that is there is
refused, never ignored, and without one the run starts from random
weights, as the JAX package does.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from bmnas_tpu_torch.cli.common import (
    _stage_seed,
    add_common_flags,
    apply_resume,
    fail_fast_checks,
    model_kwargs_from_args,
    run_test_only,
)

BACKBONE_CHECKPOINTS = ("ske_cp", "rgb_cp", "imagenet_cp")


def _add_ntu_flags(parser: argparse.ArgumentParser, *, search: bool) -> None:
    add_common_flags(parser, datadir_default='BM-NAS_dataset/NTU/',
                     batchsize=96, C=128, L=8, num_input_nodes=8,
                     num_outputs=60, eta_max=1e-3 if search else 3e-4,
                     epochs=30 if search else 50, node_steps=2,
                     steps=2 if search else 4, node_multiplier=2, drpt=0.2,
                     weight_decay=3e-4, num_workers=16,
                     Ti=1 if search else 5)
    parser.add_argument('--j', dest='num_workers', type=int,
                        help='alias of --num_workers')
    parser.add_argument('--checkpointdir', type=str,
                        default='checkpoints/ntu',
                        help='pretrained backbones (refused when present: '
                             'not ported yet)')
    parser.add_argument('--ske_cp', type=str,
                        default='skeleton_32frames_85.24.checkpoint')
    parser.add_argument('--rgb_cp', type=str,
                        default='rgb_8frames_83.91.checkpoint')
    parser.add_argument('--imagenet_cp', type=str,
                        default='resnet50_imagenet.pth')
    parser.add_argument('--modality', type=str, default='both',
                        help='parsed and read by nothing, as in the JAX '
                             'package (both modalities always run)')
    parser.add_argument('--vid_dim', action='store', default=256, type=int)
    parser.add_argument('--vid_fr', action='store', default=30, type=int,
                        help='parsed and read by nothing, as in the JAX '
                             'package (the clip directory is always '
                             '<vid_dim>x<vid_dim>_30)')
    parser.add_argument('--vid_len', action='store', default=(8, 32),
                        type=int, nargs='+')
    parser.add_argument('--remat', action='store_true', default=False,
                        help='rerun each 3D ResNet bottleneck in the '
                             'backward instead of keeping its activations '
                             '(torch.utils.checkpoint): found retraining at '
                             'batch 96 on one card')
    parser.add_argument('--device_cache_budget_gb', type=float, default=10.0,
                        help='(not ported yet) device data cache budget')
    parser.add_argument('--device', type=str, default=None,
                        help="torch device (default: the current CUDA "
                             "device; 'cpu' must be asked for)")
    if not search:
        parser.add_argument('--search_exp_dir', type=str, default=None,
                            help='retrain the best genotype of this search')
        parser.add_argument('--fused_kernels', action='store_true',
                            help='run eval found cells through the '
                                 'found-cell kernel wrapper on the CPU too '
                                 '(on CUDA they always run the kernel)')
        parser.add_argument('--node_variant', type=str, default='bmnas',
                            choices=['bmnas', 'darts', 'mfas', 'aoa',
                                     'two_head_attn'])
        parser.add_argument('--task_variant', type=str, default='bmnas',
                            choices=['bmnas', 'simple_concat',
                                     'ensemble_concat', 'ensemble',
                                     'simple_concat_attn'],
                            help='whole-net ablation baselines in place of '
                                 'the found net (models/ntu.py '
                                 'NTUAblationNet)')
        parser.add_argument('--eval_exp_dir', type=str, default=None,
                            help='test-only: the best snapshot of this '
                                 'found run')
        parser.add_argument('--momentum', type=float, default=0.9,
                            help='parsed and read by nothing, as in the JAX '
                                 'package (the optimizer is Adam)')


def parse_search_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Modality optimization.')
    _add_ntu_flags(parser, search=True)
    return parser.parse_args(argv)


def parse_found_args(argv=None) -> argparse.Namespace:
    """The NTU found defaults: C=128, L=8, steps 4, multiplier 2,
    node_steps 2, node_multiplier 2, 8 input nodes, 60 classes, batch 96,
    ``--vid_len 8 32`` frames of ``--vid_dim`` 256."""
    parser = argparse.ArgumentParser(description='Modality optimization.')
    _add_ntu_flags(parser, search=False)
    return parser.parse_args(argv)


def counts_fn(logits, labels, mask):
    from bmnas_tpu_torch.utils.metrics import accuracy_counts
    return accuracy_counts(logits, labels, mask)


def refuse_backbone_checkpoints(args) -> None:
    """Raise SystemExit when ``--checkpointdir`` holds a backbone
    checkpoint: importing one is ROADMAP.md Queue 1 item 8, and a
    checkpoint that is there is never ignored."""
    present = [os.path.join(args.checkpointdir, getattr(args, k))
               for k in BACKBONE_CHECKPOINTS]
    present = [p for p in present if os.path.exists(p)]
    if present:
        raise SystemExit(
            f"backbone checkpoints {present}: importing them is not ported "
            "yet (ROADMAP.md Queue 1 item 8, checkpoint import)")


def _log_random_init(args, logger) -> None:
    logger.info("Backbone checkpoints not found under %s - using random "
                "init", args.checkpointdir)


def _setup_data(args, device, stages):
    """Sizes and per-epoch loaders of ``stages`` (phase -> split); the
    train phase gets the random temporal crop."""
    from bmnas_tpu_torch.cli.mmimdb import batches_on
    from bmnas_tpu_torch.data.ntu import NTUDataset
    datasets = {
        phase: NTUDataset(args.datadir, stage,
                          small_dataset=args.small_dataset,
                          vid_len=tuple(args.vid_len), vid_dim=args.vid_dim,
                          num_workers=args.num_workers,
                          train_transform=phase == "train")
        for phase, stage in stages.items()}

    def loader(phase):
        def make(epoch):
            return batches_on(device, datasets[phase].batches(
                args.batchsize, shuffle=True,
                seed=(args.seed * 1000003 + epoch * 131
                      + _stage_seed(phase))))
        return make

    return ({p: len(d) for p, d in datasets.items()},
            {p: loader(p) for p in stages})


def run_search(args, logger, device):
    """Bilevel search; returns (best dev accuracy, best genotype)."""
    from bmnas_tpu_torch.models.ntu import (
        NTU_SEARCH_FROZEN_PREFIXES,
        SearchableSkeletonImageNet,
    )
    from bmnas_tpu_torch.models.supernet import (
        derive_genotype_from_arch,
        init_arch_params,
    )
    from bmnas_tpu_torch.search import loop as train_loop
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        build_step_functions,
        cross_entropy,
        freeze,
        make_arch_optimizer,
        make_weight_optimizer,
    )
    from bmnas_tpu_torch.search.scheduler import LRCosineAnnealingScheduler
    from bmnas_tpu_torch.visualize import Plotter

    dataset_sizes, loaders = _setup_data(
        args, device, {"train": "train_exp", "dev": "dev"})
    nbpe = -(-dataset_sizes["train"] // args.batchsize)  # len(dataloader)
    # weights drawn on the CPU, so a seed gives the same net on any device
    torch.manual_seed(args.seed)
    model = SearchableSkeletonImageNet(remat=args.remat,
                                       **model_kwargs_from_args(args))
    _log_random_init(args, logger)
    model = model.to(device)
    freeze(model, NTU_SEARCH_FROZEN_PREFIXES)
    arch = init_arch_params(torch.Generator().manual_seed(args.seed + 1),
                            args.steps, args.num_input_nodes,
                            args.node_steps, device=device)
    state = TrainState(
        model=model, arch=arch,
        opt_w=make_weight_optimizer(model, NTU_SEARCH_FROZEN_PREFIXES,
                                    args.weight_decay),
        opt_arch=make_arch_optimizer(arch, args.arch_learning_rate,
                                     args.arch_weight_decay))
    scheduler = LRCosineAnnealingScheduler(args.eta_max, args.eta_min,
                                           args.Ti, args.Tm, nbpe)

    def genotype_fn(st):
        return derive_genotype_from_arch(
            st.arch, args.steps, args.multiplier, args.num_input_nodes,
            args.node_steps, args.node_multiplier)

    state, resume_info = apply_resume(state, scheduler, args, logger)
    best_acc, best_genotype, _ = train_loop.run_training(
        task="ntu", status="search",
        fns=build_step_functions(cross_entropy, counts_fn), state=state,
        scheduler=scheduler, loaders=loaders, dataset_sizes=dataset_sizes,
        num_epochs=args.epochs, metric="acc", f1_type="weighted", args=args,
        logger=logger, plotter=Plotter(args), genotype_fn=genotype_fn,
        resume_info=resume_info)
    return best_acc, best_genotype


def build_found_model(args, genotype, device):
    """The found net of ``genotype``, or the ``--task_variant`` ablation
    net (which ignores the genotype), with its weights drawn on the CPU
    from ``--seed`` and moved to ``device``. On CUDA every eval found cell
    runs the found-cell kernel, so a cell it cannot host is refused
    here."""
    from bmnas_tpu_torch.models.foundnet import FoundNodeCell
    from bmnas_tpu_torch.models.ntu import (
        FoundSkeletonImageNet,
        NTUAblationNet,
    )
    torch.manual_seed(args.seed)
    if args.task_variant != "bmnas":
        model = NTUAblationNet(C=args.C, L=args.L,
                               num_outputs=args.num_outputs, drpt=args.drpt,
                               variant=args.task_variant, remat=args.remat)
    else:
        model = FoundSkeletonImageNet.from_genotype(
            genotype, node_variant=args.node_variant,
            fused_eval=args.fused_kernels, remat=args.remat,
            **model_kwargs_from_args(args))
    model = model.to(device)
    if device.type == "cuda":
        for m in model.modules():
            if isinstance(m, FoundNodeCell):
                m._check_hostable()
    return model


def run_found(args, logger, device, genotype, test_model_path=None):
    """Found-net retraining, or test-only when ``test_model_path`` is
    given. Returns the best test accuracy (retraining) or the test
    accuracy."""
    from bmnas_tpu_torch.search import loop as train_loop
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        build_step_functions,
        cross_entropy,
        make_weight_optimizer,
    )
    from bmnas_tpu_torch.search.scheduler import LRCosineAnnealingScheduler
    from bmnas_tpu_torch.visualize import Plotter

    dataset_sizes, loaders = _setup_data(
        args, device, {"train": "train_val", "test": "test"})
    nbpe = -(-dataset_sizes["train"] // args.batchsize)  # len(dataloader)
    model = build_found_model(args, genotype, device)
    _log_random_init(args, logger)
    # the found phase trains every parameter, the backbones included
    state = TrainState(
        model=model, arch=None,
        opt_w=make_weight_optimizer(model, (), args.weight_decay),
        opt_arch=None)
    fns = build_step_functions(cross_entropy, counts_fn)
    scheduler = LRCosineAnnealingScheduler(args.eta_max, args.eta_min,
                                           args.Ti, args.Tm, nbpe)

    if test_model_path is not None:
        host = run_test_only(fns, state, loaders["test"], test_model_path)
        acc = float(host["correct"]) / dataset_sizes["test"]
        loss = float(host["loss_sum"]) / dataset_sizes["test"]
        logger.info(str(genotype))
        logger.info('test Loss: {:.4f} Acc: {:.4f}'.format(loss, acc))
        return acc

    state, resume_info = apply_resume(state, scheduler, args, logger)
    best_acc, _, _ = train_loop.run_training(
        task="ntu", status="eval", fns=fns, state=state,
        scheduler=scheduler, loaders=loaders, dataset_sizes=dataset_sizes,
        num_epochs=args.epochs, metric="acc", f1_type="weighted", args=args,
        logger=logger, plotter=Plotter(args),
        genotype_fn=lambda st: genotype, resume_info=resume_info)
    return best_acc


def main_search(argv=None):
    from bmnas_tpu_torch.device import resolve_device
    from bmnas_tpu_torch.utils.experiment import create_exp_dir, setup_logger
    args = parse_search_args(argv)
    fail_fast_checks(args)
    refuse_backbone_checkpoints(args)
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    args.save = 'search-{}-{}'.format(args.save,
                                      time.strftime("%Y%m%d-%H%M%S"))
    args.save = create_exp_dir(os.path.join('final_exp/ntu', args.save))
    logger = setup_logger(args.save)
    logger.info("args = %s", args)
    logger.info("BM-NAS for NTU Started.")
    start_time = time.time()
    best_acc, best_genotype = run_search(args, logger, device)
    time_elapsed = time.time() - start_time
    logger.info("*" * 50)
    logger.info('Searching complete in {:.0f}m {:.0f}s'.format(
        time_elapsed // 60, time_elapsed % 60))
    logger.info('Now listing best fusion_net genotype:')
    logger.info(best_genotype)
    return best_acc, best_genotype


def main_found(argv=None):
    from bmnas_tpu_torch.device import resolve_device
    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.utils.experiment import create_exp_dir, setup_logger
    args = parse_found_args(argv)
    test_model_path = None
    stamp = time.strftime("%Y%m%d-%H%M%S")
    if args.eval_exp_dir is not None:
        args.save = os.path.join(args.eval_exp_dir,
                                 'test-{}-{}'.format(args.save, stamp))
        test_model_path = os.path.join(args.eval_exp_dir, 'best',
                                       'best_test_model.pt')
        best_genotype_path = os.path.join(args.eval_exp_dir, 'best',
                                          'best_test_genotype.pkl')
    elif args.search_exp_dir is not None:
        best_genotype_path = os.path.join(args.search_exp_dir, 'best',
                                          'best_genotype.pkl')
        args.save = os.path.join(args.search_exp_dir,
                                 'eval-{}-{}'.format(args.save, stamp))
    else:
        raise SystemExit("one of --search_exp_dir / --eval_exp_dir is "
                         "required")
    fail_fast_checks(args)
    refuse_backbone_checkpoints(args)
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    args.save = create_exp_dir(args.save)
    logger = setup_logger(args.save)
    logger.info("args = %s", args)

    # the ablation nets take no genotype (their runs write none)
    genotype = (load_genotype(best_genotype_path)
                if args.task_variant == "bmnas" else None)
    start_time = time.time()
    acc = run_found(args, logger, device, genotype, test_model_path)
    time_elapsed = time.time() - start_time
    logger.info("*" * 50)
    logger.info('Total duration {:.0f}m {:.0f}s'.format(
        time_elapsed // 60, time_elapsed % 60))
    logger.info('Final model Acc: {}'.format(acc))
    return acc


if __name__ == "__main__":
    main_search()
