"""Searcher facades: a task's searcher owns its data and runs the search.

Port of ``bmnas_tpu/searchers.py`` for the tasks the port has (MM-IMDB and
NTU; the Ego searcher comes with the Ego slice):

    searcher = NTUSearcher(args, logger)   # args from cli.ntu.parse_search_args
    best_metric, best_genotype = searcher.search()

``device`` defaults to ``args.device`` (the current CUDA device when that
is None; the CPU must be asked for).
"""
from __future__ import annotations


class _SearcherBase:
    _run = None

    def __init__(self, args, logger, device=None):
        from bmnas_tpu_torch.device import resolve_device
        self.args = args
        self.logger = logger
        self.device = resolve_device(
            device if device is not None else getattr(args, "device", None))

    def search(self):
        return type(self)._run(self.args, self.logger, self.device)


class MMIMDBSearcher(_SearcherBase):
    @staticmethod
    def _run(args, logger, device):
        from bmnas_tpu_torch.cli.mmimdb import run_search
        return run_search(args, logger, device)


class NTUSearcher(_SearcherBase):
    @staticmethod
    def _run(args, logger, device):
        from bmnas_tpu_torch.cli.ntu import run_search
        return run_search(args, logger, device)


# the reference's spelling
MMIMDB_Searcher = MMIMDBSearcher
