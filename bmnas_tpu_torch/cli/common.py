"""Shared CLI plumbing: the reference's common flag set.

Port of the ``add_common_flags`` / ``model_kwargs_from_args`` /
``fail_fast_checks`` subset of ``bmnas_tpu/cli/common.py``. The JAX
package's TPU-specific flags (device data cache, dispatch fusion, H2D
streams, profiler, grain backend) have no counterpart here yet. Both
spellings ``--use_dataparallel`` / ``--parallel`` are accepted as in the
reference, but the port runs on one device and refuses the flag.
"""
from __future__ import annotations

import argparse
import os


def add_common_flags(parser: argparse.ArgumentParser, *, datadir_default: str,
                     batchsize: int, C: int, L: int, num_input_nodes: int,
                     num_outputs: int, eta_max: float = 1e-3,
                     epochs: int = 30, node_steps: int = 1,
                     steps: int = 2) -> None:
    parser.add_argument('--seed', type=int, default=2, help='random seed')
    parser.add_argument('--save', type=str, default='EXP',
                        help='where to save the experiment')
    parser.add_argument('--datadir', type=str, default=datadir_default,
                        help='data directory')
    parser.add_argument('--small_dataset', action='store_true', default=False,
                        help='use mini dataset for debugging')
    parser.add_argument('--num_workers', type=int, default=32,
                        help='dataloader threads')
    parser.add_argument('--use_dataparallel', dest='parallel',
                        action='store_true', default=False,
                        help='data parallelism over several devices '
                             '(not in the port yet)')
    parser.add_argument('--parallel', dest='parallel', action='store_true',
                        help='alias of --use_dataparallel')
    parser.add_argument('--batchsize', type=int, default=batchsize)
    parser.add_argument('--epochs', type=int, default=epochs)
    parser.add_argument('--drpt', action='store', default=0.1, dest='drpt',
                        type=float, help='dropout')
    parser.add_argument('--num_input_nodes', type=int, default=num_input_nodes,
                        help='total number of modality features')
    parser.add_argument('--num_keep_edges', type=int, default=2,
                        help='cells and steps will have 2 input edges')
    parser.add_argument('--C', type=int, default=C,
                        help='channels for conv layer')
    parser.add_argument('--L', type=int, default=L,
                        help='length after conv and pool')
    parser.add_argument('--multiplier', type=int, default=2,
                        help='cell output concat')
    parser.add_argument('--steps', type=int, default=steps, help='cell steps')
    parser.add_argument('--node_steps', type=int, default=node_steps,
                        help='inner node steps')
    parser.add_argument('--node_multiplier', type=int, default=1,
                        help='inner node output concat')
    parser.add_argument('--num_outputs', type=int, default=num_outputs,
                        help='output dimension')
    parser.add_argument('--arch_learning_rate', type=float, default=3e-4,
                        help='learning rate for arch encoding')
    parser.add_argument('--arch_weight_decay', type=float, default=1e-3,
                        help='weight decay for arch encoding')
    parser.add_argument('--weight_decay', type=float, default=1e-4)
    parser.add_argument('--eta_max', type=float, default=eta_max,
                        help='max learning rate')
    parser.add_argument('--eta_min', type=float, default=1e-6,
                        help='min learning rate')
    parser.add_argument('--Ti', type=int, default=1,
                        help='cosine annealing epochs Ti')
    parser.add_argument('--Tm', type=int, default=2,
                        help='cosine annealing multiplier Tm')


def model_kwargs_from_args(args) -> dict:
    return dict(C=args.C, L=args.L, steps=args.steps,
                multiplier=args.multiplier, node_steps=args.node_steps,
                node_multiplier=args.node_multiplier,
                num_input_nodes=args.num_input_nodes,
                num_keep_edges=args.num_keep_edges,
                num_outputs=args.num_outputs, drpt=args.drpt)


def fail_fast_checks(args) -> None:
    """Validate host-side arguments before any model is built."""
    datadir = getattr(args, "datadir", None)
    if datadir and not os.path.isdir(datadir):
        raise SystemExit(f"--datadir: directory not found: {datadir}")
    if getattr(args, "parallel", False):
        raise SystemExit("--parallel/--use_dataparallel: the port runs on "
                         "one device (multi-device serving is a later "
                         "ROADMAP item)")
