"""NTU found-net retraining and test-only (``cli.ntu.main_found``).

    python -m bmnas_tpu_torch.cli.ntu_found --search_exp_dir <exp> \\
        --datadir <root> [--remat] [--task_variant ...] [--device cpu]
    python -m bmnas_tpu_torch.cli.ntu_found --eval_exp_dir <eval exp> \\
        --datadir <root> [--device cpu]
"""
from bmnas_tpu_torch.cli.ntu import main_found

if __name__ == "__main__":
    main_found()
