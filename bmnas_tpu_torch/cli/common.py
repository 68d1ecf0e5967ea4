"""Shared CLI plumbing: the reference's common flag set, resume, test-only.

Port of the ``add_common_flags`` / ``model_kwargs_from_args`` /
``fail_fast_checks`` / ``_stage_seed`` / ``apply_resume`` /
``run_test_only`` subset of ``bmnas_tpu/cli/common.py``. The JAX package's
flags whose machinery is not ported yet are parsed and refused with the
ROADMAP.md item that brings them (:data:`NOT_PORTED`), never ignored. Both spellings
``--use_dataparallel`` / ``--parallel`` are accepted as in the reference,
but the port runs on one device and refuses the flag.
"""
from __future__ import annotations

import argparse
import os
import zlib

# flag -> (is it set?, the ROADMAP.md item that ports it)
NOT_PORTED = {
    "--unrolled": (lambda a: a.unrolled,
                   "Queue 1 item 3, search extras"),
    "--steps_per_dispatch": (lambda a: a.steps_per_dispatch != 1,
                             "Queue 1 item 3, search extras"),
    "--bf16_backbone": (lambda a: a.bf16_backbone,
                        "Queue 1 item 3, search extras"),
    "--profile_dir": (lambda a: a.profile_dir is not None,
                      "Queue 1 item 3, search extras"),
    "--device_data_cache": (lambda a: a.device_data_cache,
                            "Queue 1 item 6, data-path infrastructure"),
    "--data_backend grain": (lambda a: a.data_backend == "grain",
                             "Queue 1 item 6, data-path infrastructure"),
    "--h2d_streams": (lambda a: a.h2d_streams != 1,
                      "Queue 1 item 6, data-path infrastructure"),
    # 0 (in-process) is taken and ignored, as the JAX package does with the
    # threads backend
    "--grain_workers": (lambda a: a.grain_workers > 0,
                        "Queue 1 item 6, data-path infrastructure"),
    "--parallel": (lambda a: a.parallel,
                   "Queue 1 item 7, multi-device"),
    # the NTU CLIs' parser (cli/ntu.py)
    "--device_cache_budget_gb": (
        lambda a: getattr(a, "device_cache_budget_gb", 10.0) != 10.0,
        "Queue 1 item 6, data-path infrastructure"),
    # the serve CLI's top parser (cli/serve.py)
    "--export": (lambda a: getattr(a, "export", None) is not None,
                 "Queue 1 item 10, torch.export"),
    "--from_export": (lambda a: getattr(a, "from_export", None) is not None,
                      "Queue 1 item 10, torch.export"),
    # the Ego CLIs' parser (cli/ego.py)
    "--host_decode_cache_gb": (
        lambda a: getattr(a, "host_decode_cache_gb", 0.0) > 0,
        "Queue 1 item 5b, the Ego search and found retraining"),
}


def add_common_flags(parser: argparse.ArgumentParser, *, datadir_default: str,
                     batchsize: int, C: int, L: int, num_input_nodes: int,
                     num_outputs: int, eta_max: float = 1e-3,
                     epochs: int = 30, node_steps: int = 1,
                     steps: int = 2, node_multiplier: int = 1,
                     drpt: float = 0.1, weight_decay: float = 1e-4,
                     num_workers: int = 32, Ti: int = 1) -> None:
    parser.add_argument('--seed', type=int, default=2, help='random seed')
    parser.add_argument('--save', type=str, default='EXP',
                        help='where to save the experiment')
    parser.add_argument('--datadir', type=str, default=datadir_default,
                        help='data directory')
    parser.add_argument('--small_dataset', action='store_true', default=False,
                        help='use mini dataset for debugging')
    parser.add_argument('--num_workers', type=int, default=num_workers,
                        help='dataloader threads')
    parser.add_argument('--use_dataparallel', dest='parallel',
                        action='store_true', default=False,
                        help='data parallelism over several devices '
                             '(not in the port yet)')
    parser.add_argument('--parallel', dest='parallel', action='store_true',
                        help='alias of --use_dataparallel')
    parser.add_argument('--batchsize', type=int, default=batchsize)
    parser.add_argument('--epochs', type=int, default=epochs)
    parser.add_argument('--drpt', action='store', default=drpt, dest='drpt',
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
    parser.add_argument('--node_multiplier', type=int,
                        default=node_multiplier,
                        help='inner node output concat')
    parser.add_argument('--num_outputs', type=int, default=num_outputs,
                        help='output dimension')
    parser.add_argument('--arch_learning_rate', type=float, default=3e-4,
                        help='learning rate for arch encoding')
    parser.add_argument('--arch_weight_decay', type=float, default=1e-3,
                        help='weight decay for arch encoding')
    parser.add_argument('--weight_decay', type=float, default=weight_decay)
    parser.add_argument('--eta_max', type=float, default=eta_max,
                        help='max learning rate')
    parser.add_argument('--eta_min', type=float, default=1e-6,
                        help='min learning rate')
    parser.add_argument('--Ti', type=int, default=Ti,
                        help='cosine annealing epochs Ti')
    parser.add_argument('--Tm', type=int, default=2,
                        help='cosine annealing multiplier Tm')
    # --resume, then the flags of the JAX package that the port parses and
    # refuses (NOT_PORTED)
    parser.add_argument('--resume', type=str, default=None,
                        help='resume from an <exp>/checkpoint.pt')
    parser.add_argument('--profile_dir', type=str, default=None,
                        help='(not ported yet) profiler trace directory')
    parser.add_argument('--bf16_backbone', action='store_true',
                        default=False,
                        help='(not ported yet) bf16 image backbone')
    parser.add_argument('--device_data_cache', action='store_true',
                        default=False,
                        help='(not ported yet) device-resident dataset')
    parser.add_argument('--steps_per_dispatch', type=int, default=1,
                        help='(not ported yet) steps fused per dispatch')
    parser.add_argument('--h2d_streams', type=int, default=1,
                        help='(not ported yet) concurrent host->device '
                             'transfer streams for streamed batches')
    parser.add_argument('--unrolled', action='store_true', default=False,
                        help='(not ported yet) second-order arch steps')
    parser.add_argument('--data_backend', type=str, default='threads',
                        choices=['threads', 'grain'],
                        help='host input pipeline (grain: not ported yet)')
    parser.add_argument('--grain_workers', type=int, default=0,
                        help='grain worker processes (0 = in-process; '
                             'above 0 not ported yet)')


def model_kwargs_from_args(args) -> dict:
    return dict(C=args.C, L=args.L, steps=args.steps,
                multiplier=args.multiplier, node_steps=args.node_steps,
                node_multiplier=args.node_multiplier,
                num_input_nodes=args.num_input_nodes,
                num_keep_edges=args.num_keep_edges,
                num_outputs=args.num_outputs, drpt=args.drpt)


def refuse_not_ported(args, flags=tuple(NOT_PORTED)) -> None:
    """Raise SystemExit naming the ROADMAP.md item of the first of ``flags``
    that ``args`` sets to another value than its default."""
    for flag in flags:
        is_set, item = NOT_PORTED[flag]
        if is_set(args):
            raise SystemExit(f"{flag}: not ported yet (ROADMAP.md {item})")


def fail_fast_checks(args) -> None:
    """Validate host-side arguments before any model is built; refuse the
    flags the port does not have yet."""
    refuse_not_ported(args)
    resume = getattr(args, "resume", None)
    if resume and not os.path.exists(resume):
        raise SystemExit(f"--resume: checkpoint not found: {resume}")
    datadir = getattr(args, "datadir", None)
    if datadir and not os.path.isdir(datadir):
        raise SystemExit(f"--datadir: directory not found: {datadir}")


def _stage_seed(stage: str) -> int:
    """Deterministic per-stage seed term (Python's hash() is randomized per
    process)."""
    return zlib.crc32(stage.encode()) % 97


def apply_resume(state, scheduler, args, logger):
    """--resume <exp>/checkpoint.pt: restore the full train state (in place)
    and the scheduler.

    Returns ``(state, resume_info)``; ``resume_info`` (None without
    --resume) carries ``start_epoch`` (training goes on after the
    checkpointed epoch, with the data seeds and LR schedule an
    uninterrupted run would have used), the best metrics and epochs, and
    the best genotypes reloaded from the checkpoint dir's ``best/``
    pickles."""
    if not getattr(args, "resume", None):
        return state, None
    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.utils import checkpoint as ckpt
    extra = ckpt.restore_state(args.resume, state)
    scheduler.load_state(extra["scheduler"])
    info = {
        "start_epoch": int(extra["epoch"]) + 1,
        "best_metric": float(extra["best_metric"]),
        "best_test_metric": float(extra["best_test_metric"]),
        "best_epoch": int(extra["best_epoch"]),
        "best_test_epoch": int(extra["best_test_epoch"]),
        "best_genotype": None,
        "best_test_genotype": None,
    }
    best_dir = os.path.join(os.path.dirname(os.path.abspath(args.resume)),
                            "best")
    for key, fname in (("best_genotype", "best_genotype.pkl"),
                       ("best_test_genotype", "best_test_genotype.pkl")):
        path = os.path.join(best_dir, fname)
        if os.path.exists(path):
            info[key] = load_genotype(path)
    logger.info("Resumed from %s; continuing at epoch %s", args.resume,
                info["start_epoch"])
    return state, info


def run_test_only(fns, state, loader, snapshot_path):
    """Test-only mode: load a ``best_*_model.pt`` snapshot into the model,
    run one eval pass over ``loader(0)``; returns the summed counts on the
    host (numpy)."""
    import numpy as np

    from bmnas_tpu_torch.utils import checkpoint as ckpt
    state.model.load_state_dict(ckpt.load_model(snapshot_path))
    total = None
    for b in loader(0):
        c = fns.eval_step(state, b)
        total = c if total is None else {k: total[k] + c[k] for k in total}
    return {k: np.asarray(v.cpu()) for k, v in total.items()}
