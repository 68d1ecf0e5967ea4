"""MM-IMDB entry points: the bilevel search, and the found-net flags.

Port of ``bmnas_tpu/cli/mmimdb.py`` (parse_search_args, counts_fn,
run_search, main_search, parse_found_args, TH_FSCORE). The search runs on
CUDA unless ``--device cpu`` is given, and raises when there is no CUDA
device:

    python -m bmnas_tpu_torch.cli.mmimdb --datadir <root> [--epochs N] \\
        [--batchsize 8] [--C 192] [--L 16] [--device cpu]

It writes ``final_exp/mmimdb/search-<save>-<timestamp>/`` under the working
directory: ``log.txt``, ``metrics.jsonl``, ``best/best_model.pt``,
``best/best_genotype.pkl`` and ``architectures/epoch_N``. Found retraining
is a later slice (ROADMAP.md Queue 1 item 2).
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
    fail_fast_checks,
    model_kwargs_from_args,
)

TH_FSCORE = 0.3  # sigmoid threshold of a positive genre


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='BM-NAS Configuration')
    add_common_flags(parser, datadir_default='BM-NAS_dataset/mmimdb/dataset/',
                     batchsize=8, C=192, L=16, num_input_nodes=6,
                     num_outputs=23)
    return parser


def parse_search_args(argv=None):
    parser = _parser()
    parser.add_argument('--f1_type', type=str, default='weighted',
                        help="use 'weighted' or 'macro' F1 Score")
    parser.add_argument('--device', type=str, default=None,
                        help="torch device (default: the current CUDA "
                             "device; 'cpu' must be asked for)")
    return parser.parse_args(argv)


def parse_found_args(argv=None):
    parser = _parser()
    parser.add_argument('--f1_type', type=str, default='weighted')
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


def _setup_data(args, device, stages=("train", "dev")):
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

    best_f1, best_genotype, _ = train_loop.run_training(
        task="mmimdb", fns=build_step_functions(bce_with_logits, counts_fn),
        state=state, scheduler=scheduler, loaders=loaders,
        dataset_sizes=dataset_sizes, num_epochs=args.epochs,
        f1_type=args.f1_type, args=args, logger=logger,
        plotter=Plotter(args), genotype_fn=genotype_fn)
    return best_f1, best_genotype


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


if __name__ == "__main__":
    main_search()
