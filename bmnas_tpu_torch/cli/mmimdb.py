"""MM-IMDB entry points: the bilevel search, found retraining and test-only.

Port of ``bmnas_tpu/cli/mmimdb.py`` (parse_search_args, parse_found_args,
counts_fn, run_search, run_found, main_search, main_found, TH_FSCORE). Both
run on CUDA unless ``--device cpu`` is given, and raise when there is no
CUDA device:

    python -m bmnas_tpu_torch.cli.mmimdb --datadir <root> [--epochs N] \\
        [--batchsize 8] [--C 192] [--L 16] [--resume <ckpt>] [--device cpu]
    python -m bmnas_tpu_torch.cli.mmimdb_found --search_exp_dir <exp> \\
        --datadir <root> [--node_variant bmnas] [--fused_kernels] \\
        [--resume <ckpt>] [--device cpu]
    python -m bmnas_tpu_torch.cli.mmimdb_found --eval_exp_dir <eval exp> \\
        --datadir <root> [--device cpu]

The search writes ``final_exp/mmimdb/search-<save>-<timestamp>/`` under the
working directory: ``log.txt``, ``metrics.jsonl``, ``checkpoint.pt``,
``best/best_model.pt``, ``best/best_genotype.pkl`` and
``architectures/epoch_N``. Found retraining writes
``<search exp>/eval-<save>-<timestamp>/`` with the same files, the best ones
being ``best/best_test_model.pt`` and ``best/best_test_genotype.pkl``;
test-only writes ``<eval exp>/test-<save>-<timestamp>/log.txt``.
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

TH_FSCORE = 0.3  # sigmoid threshold of a positive genre


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='BM-NAS Configuration')
    add_common_flags(parser, datadir_default='BM-NAS_dataset/mmimdb/dataset/',
                     batchsize=8, C=192, L=16, num_input_nodes=6,
                     num_outputs=23)
    return parser


def _add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('--device', type=str, default=None,
                        help="torch device (default: the current CUDA "
                             "device; 'cpu' must be asked for)")


def parse_search_args(argv=None):
    parser = _parser()
    parser.add_argument('--f1_type', type=str, default='weighted',
                        help="use 'weighted' or 'macro' F1 Score")
    _add_device_flag(parser)
    return parser.parse_args(argv)


def parse_found_args(argv=None):
    parser = _parser()
    parser.add_argument('--f1_type', type=str, default='weighted')
    _add_device_flag(parser)
    parser.add_argument('--search_exp_dir', type=str, default=None,
                        help='evaluate which search exp')
    parser.add_argument('--fused_kernels', action='store_true',
                        help='run eval found cells through the found-cell '
                             'kernel wrapper on the CPU too (on CUDA they '
                             'always run the kernel)')
    parser.add_argument('--node_variant', type=str, default='bmnas',
                        choices=['bmnas', 'darts', 'mfas', 'aoa',
                                 'two_head_attn'],
                        help='fusion-node ablation variant')
    parser.add_argument('--eval_exp_dir', type=str, default=None,
                        help='test which eval exp')
    return parser.parse_args(argv)


def counts_fn(logits, labels, mask):
    from bmnas_tpu_torch.utils.metrics import multilabel_counts
    preds = (torch.sigmoid(logits) > TH_FSCORE).float()
    return multilabel_counts(preds, labels, mask)


def batches_on(device, host_batches):
    """Host numpy batches as tensors on ``device``."""
    for b in host_batches:
        yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _setup_data(args, device, stages=("train", "dev", "test")):
    """Sizes and per-epoch loaders of the splits; the search never reads
    the test split."""
    from bmnas_tpu_torch.data.mmimdb import MMIMDBDataset
    datasets = {s: MMIMDBDataset(args.datadir, s,
                                 small_dataset=args.small_dataset,
                                 num_workers=args.num_workers)
                for s in stages}

    def loader(stage):
        def make(epoch):
            return batches_on(device, datasets[stage].batches(
                args.batchsize, shuffle=True,
                seed=(args.seed * 1000003 + epoch * 131
                      + _stage_seed(stage))))
        return make

    return ({s: len(d) for s, d in datasets.items()},
            {s: loader(s) for s in stages})


def run_search(args, logger, device):
    """Bilevel search; returns (best dev F1, best genotype)."""
    from bmnas_tpu_torch.models.mmimdb import (
        MMIMDB_FROZEN_PREFIXES,
        SearchableImageTextNet,
    )
    from bmnas_tpu_torch.models.supernet import (
        derive_genotype_from_arch,
        init_arch_params,
    )
    from bmnas_tpu_torch.search import loop as train_loop
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        bce_with_logits,
        build_step_functions,
        freeze,
        make_arch_optimizer,
        make_weight_optimizer,
    )
    from bmnas_tpu_torch.search.scheduler import LRCosineAnnealingScheduler
    from bmnas_tpu_torch.visualize import Plotter

    dataset_sizes, loaders = _setup_data(args, device)
    nbpe = -(-dataset_sizes["train"] // args.batchsize)  # len(dataloader)
    # weights drawn on the CPU, so a seed gives the same net on any device
    torch.manual_seed(args.seed)
    model = SearchableImageTextNet(**model_kwargs_from_args(args)).to(device)
    freeze(model, MMIMDB_FROZEN_PREFIXES)
    arch = init_arch_params(torch.Generator().manual_seed(args.seed + 1),
                            args.steps, args.num_input_nodes,
                            args.node_steps, device=device)
    state = TrainState(
        model=model, arch=arch,
        opt_w=make_weight_optimizer(model, MMIMDB_FROZEN_PREFIXES,
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
    best_f1, best_genotype, _ = train_loop.run_training(
        task="mmimdb", status="search",
        fns=build_step_functions(bce_with_logits, counts_fn), state=state,
        scheduler=scheduler, loaders=loaders, dataset_sizes=dataset_sizes,
        num_epochs=args.epochs, f1_type=args.f1_type, args=args,
        logger=logger, plotter=Plotter(args), genotype_fn=genotype_fn,
        resume_info=resume_info)
    return best_f1, best_genotype


def run_found(args, logger, device, genotype, test_model_path=None):
    """Found-net retraining, or test-only when ``test_model_path`` is
    given. Returns the best test F1 (retraining) or the test F1."""
    from bmnas_tpu_torch.models.foundnet import FoundNodeCell
    from bmnas_tpu_torch.models.mmimdb import FoundImageTextNet
    from bmnas_tpu_torch.search import loop as train_loop
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        bce_with_logits,
        build_step_functions,
        make_weight_optimizer,
    )
    from bmnas_tpu_torch.search.scheduler import LRCosineAnnealingScheduler
    from bmnas_tpu_torch.utils.metrics import f1_from_counts
    from bmnas_tpu_torch.visualize import Plotter

    dataset_sizes, loaders = _setup_data(args, device)
    nbpe = -(-dataset_sizes["train"] // args.batchsize)  # len(dataloader)
    # weights drawn on the CPU, so a seed gives the same net on any device
    torch.manual_seed(args.seed)
    model = FoundImageTextNet.from_genotype(
        genotype, node_variant=args.node_variant,
        fused_eval=args.fused_kernels, **model_kwargs_from_args(args))
    model = model.to(device)
    if device.type == "cuda":  # eval found cells run the kernel: refuse now
        for m in model.modules():
            if isinstance(m, FoundNodeCell):
                m._check_hostable()
    # the found phase trains every parameter, the backbones included
    state = TrainState(
        model=model, arch=None,
        opt_w=make_weight_optimizer(model, (), args.weight_decay),
        opt_arch=None)
    fns = build_step_functions(bce_with_logits, counts_fn)
    scheduler = LRCosineAnnealingScheduler(args.eta_max, args.eta_min,
                                           args.Ti, args.Tm, nbpe)

    if test_model_path is not None:
        host = run_test_only(fns, state, loaders["test"], test_model_path)
        loss = float(host["loss_sum"]) / dataset_sizes["test"]
        f1 = f1_from_counts(host, average=args.f1_type, zero_division=1.0)
        logger.info(str(genotype))
        logger.info('test Loss: {:.4f}, {} F1: {:.4f}'.format(
            loss, args.f1_type, f1))
        return f1

    state, resume_info = apply_resume(state, scheduler, args, logger)
    best_f1, _, _ = train_loop.run_training(
        task="mmimdb", status="eval", fns=fns, state=state,
        scheduler=scheduler, loaders=loaders, dataset_sizes=dataset_sizes,
        num_epochs=args.epochs, f1_type=args.f1_type, args=args,
        logger=logger, plotter=Plotter(args),
        genotype_fn=lambda st: genotype, resume_info=resume_info)
    return best_f1


def main_search(argv=None):
    from bmnas_tpu_torch.device import resolve_device
    from bmnas_tpu_torch.utils.experiment import create_exp_dir, setup_logger
    args = parse_search_args(argv)
    fail_fast_checks(args)
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    args.save = 'search-{}-{}'.format(args.save,
                                      time.strftime("%Y%m%d-%H%M%S"))
    args.save = create_exp_dir(os.path.join('final_exp/mmimdb', args.save))
    logger = setup_logger(args.save)
    logger.info("args = %s", args)
    logger.info("BM-NAS for MM-IMDB Started.")
    start_time = time.time()
    best_f1, best_genotype = run_search(args, logger, device)
    time_elapsed = time.time() - start_time
    logger.info("*" * 50)
    logger.info('Searching complete in {:.0f}m {:.0f}s'.format(
        time_elapsed // 60, time_elapsed % 60))
    logger.info('Now listing best fusion_net genotype:')
    logger.info(best_genotype)
    return best_f1, best_genotype


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
    device = resolve_device(args.device)
    np.random.seed(args.seed)
    args.save = create_exp_dir(args.save)
    logger = setup_logger(args.save)
    logger.info("args = %s", args)

    genotype = load_genotype(best_genotype_path)
    start_time = time.time()
    model_f1 = run_found(args, logger, device, genotype, test_model_path)
    time_elapsed = time.time() - start_time
    logger.info("*" * 50)
    logger.info('Total duration {:.0f}m {:.0f}s'.format(
        time_elapsed // 60, time_elapsed % 60))
    logger.info('Final model {} F1: {}'.format(args.f1_type, model_f1))
    return model_f1


if __name__ == "__main__":
    main_search()
