"""NTU RGB+D flags: the part of ``bmnas_tpu/cli/ntu.py::parse_found_args``
that serving reads.

The port serves NTU found nets (``cli/serve.py --task ntu``); the NTU search
and found retraining, with their backbone checkpoints, ``--modality``,
``--momentum`` and ``--remat``, are ROADMAP.md Queue 1 item 4's next part.
"""
from __future__ import annotations

import argparse

from bmnas_tpu_torch.cli.common import add_common_flags


def parse_found_args(argv=None) -> argparse.Namespace:
    """The NTU found defaults: C=128, L=8, steps 4, multiplier 2,
    node_steps 2, node_multiplier 2, 8 input nodes, 60 classes, batch 96,
    ``--vid_len 8 32`` frames of ``--vid_dim`` 256; with the model, data,
    ``--node_variant`` and ``--fused_kernels`` flags that serving reads
    (``--task_variant`` is refused until the ablation nets are ported)."""
    parser = argparse.ArgumentParser(description='Modality optimization.')
    add_common_flags(parser, datadir_default='BM-NAS_dataset/NTU/',
                     batchsize=96, C=128, L=8, num_input_nodes=8,
                     num_outputs=60, eta_max=3e-4, epochs=50, node_steps=2,
                     steps=4, node_multiplier=2, drpt=0.2,
                     weight_decay=3e-4, num_workers=16, Ti=5)
    parser.add_argument('--vid_dim', action='store', default=256, type=int)
    parser.add_argument('--vid_len', action='store', default=(8, 32),
                        type=int, nargs='+')
    parser.add_argument('--fused_kernels', action='store_true',
                        help='run eval found cells through the found-cell '
                             'kernel wrapper on the CPU too (on CUDA they '
                             'always run the kernel)')
    parser.add_argument('--node_variant', type=str, default='bmnas',
                        choices=['bmnas', 'darts', 'mfas', 'aoa',
                                 'two_head_attn'])
    parser.add_argument('--task_variant', type=str, default='bmnas',
                        choices=['bmnas', 'simple_concat', 'ensemble_concat',
                                 'ensemble', 'simple_concat_attn'],
                        help='whole-net ablation baselines (not ported yet)')
    return parser.parse_args(argv)
