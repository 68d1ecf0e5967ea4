"""MM-IMDB found-net retraining and test-only (``cli.mmimdb.main_found``).

    python -m bmnas_tpu_torch.cli.mmimdb_found --search_exp_dir <exp> \\
        --datadir <root> [--device cpu]
    python -m bmnas_tpu_torch.cli.mmimdb_found --eval_exp_dir <eval exp> \\
        --datadir <root> [--device cpu]
"""
from bmnas_tpu_torch.cli.mmimdb import main_found

if __name__ == "__main__":
    main_found()
