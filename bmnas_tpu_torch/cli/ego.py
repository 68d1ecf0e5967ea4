"""EgoGesture flags of the found net, for serving.

Port of the flags of ``bmnas_tpu/cli/ego.py::parse_found_args`` that
serving reads, with the JAX defaults: C=128, L=8, steps 2, multiplier 2,
node_steps 3, node_multiplier 3, 8 input nodes, 83 classes, batch 96,
clips of ``--sample_duration`` 32 frames of ``--sample_size`` 112,
``--datadir``, ``--checkpointdir`` (where the annotation JSON
``--annotation`` lives), ``--small_dataset``, ``--num_workers`` (alias
``--j``), ``--node_variant`` and ``--fused_kernels``, and the flags of the
JAX package that the port parses and refuses (``cli/common.py``).

The Ego search, found retraining and test-only (``main_search``,
``main_found``) come with ROADMAP.md Queue 1 item 5b. Serving takes its
weights from the snapshot and reads no pretrained backbone (``--rgb_cp``,
``--depth_cp`` under ``--checkpointdir``), as in the JAX package; the
search and found retraining will refuse one that is there until its import
is ported (item 8), as ``cli/ntu.py`` does.
"""
from __future__ import annotations

import argparse

from bmnas_tpu_torch.cli import common


def parse_found_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description='Modality optimization.')
    common.add_common_flags(
        parser, datadir_default='EgoGesture', batchsize=96, C=128, L=8,
        num_input_nodes=8, num_outputs=83, eta_max=0.003, epochs=30,
        node_steps=3, steps=2, node_multiplier=3, drpt=0.0,
        weight_decay=1e-4, num_workers=32, Ti=5)
    parser.add_argument('--j', dest='num_workers', type=int,
                        help='alias of --num_workers')
    parser.add_argument('--checkpointdir', type=str,
                        default='checkpoints/ego',
                        help='the annotation JSON (and the pretrained '
                             'backbones, which serving does not read)')
    parser.add_argument('--annotation', type=str,
                        default='egogestureall_but_None.json')
    parser.add_argument('--rgb_cp', type=str,
                        default='egogesture_resnext_1.0x_RGB_32_acc_94.01245'
                                '.pth')
    parser.add_argument('--depth_cp', type=str,
                        default='egogesture_resnext_1.0x_Depth_32_acc_93.6106'
                                '0.pth')
    parser.add_argument('--sample_size', type=int, default=112)
    parser.add_argument('--sample_duration', type=int, default=32)
    parser.add_argument('--downsample', type=int, default=1)
    parser.add_argument('--host_decode_cache_gb', type=float, default=0.0,
                        help='(not ported yet) host RAM budget of the '
                             'decode-once frame cache')
    parser.add_argument('--device_cache_budget_gb', type=float, default=10.0,
                        help='(not ported yet) device data cache budget')
    parser.add_argument('--device', type=str, default=None,
                        help="torch device (default: the current CUDA "
                             "device; 'cpu' must be asked for)")
    parser.add_argument('--fused_kernels', action='store_true',
                        help='run eval found cells through the found-cell '
                             'kernel wrapper on the CPU too (on CUDA they '
                             'always run the kernel)')
    parser.add_argument('--node_variant', type=str, default='bmnas',
                        choices=['bmnas', 'darts', 'mfas', 'aoa',
                                 'two_head_attn'])
    return parser.parse_args(argv)
