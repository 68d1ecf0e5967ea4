"""MM-IMDB found-net flags (port of ``parse_found_args`` and ``TH_FSCORE``
of ``bmnas_tpu/cli/mmimdb.py``). Search and found retraining come with a
later slice."""
from __future__ import annotations

import argparse

from bmnas_tpu_torch.cli.common import add_common_flags

TH_FSCORE = 0.3  # sigmoid threshold of a positive genre


def parse_found_args(argv=None):
    parser = argparse.ArgumentParser(description='BM-NAS Configuration')
    add_common_flags(parser, datadir_default='BM-NAS_dataset/mmimdb/dataset/',
                     batchsize=8, C=192, L=16, num_input_nodes=6,
                     num_outputs=23)
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
