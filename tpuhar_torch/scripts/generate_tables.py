"""The article-style result tables (``generate_tables.py``): a thin command line over
``report/tables.py``.

Builds every table that the result files under ``--results-dir`` allow (Table 3
few-shot, Table 4 zero-shot, Table 5 ablations) and saves each as CSV, LaTeX and
Markdown; ``--demo`` runs the tables on ``make_demo_results``' synthetic few-shot
results instead and saves them with the prefix ``demo_``. The default directory is
the port's ``outputs/torch/results``. Host work only (pandas):
``python -m tpuhar_torch.scripts.generate_tables [--results-dir DIR] [--demo]``
"""
from __future__ import annotations

import argparse
from pathlib import Path

RESULTS_DIR = Path("outputs/torch/results")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Generate article-style result tables")
    p.add_argument("--results-dir", default=None,
                   help=f"directory with result artifacts (default: {RESULTS_DIR})")
    p.add_argument("--demo", action="store_true", help="run on synthetic demo results instead of real artifacts")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the tables made, by name."""
    from ..report.tables import (
        TableGenerator,
        create_article_tables_from_results,
        format_results_for_readme,
        make_demo_results,
    )

    args = parse_args(argv)
    results_dir = Path(args.results_dir or RESULTS_DIR)
    results_dir.mkdir(parents=True, exist_ok=True)
    if args.demo:
        gen = TableGenerator(results_dir)
        demo = make_demo_results()
        tables = {
            "table3_fewshot": gen.generate_table3_style(demo),
            "comparison_probe_vs_finetune": gen.create_comparison_table(demo),
        }
        gen.save_tables(tables, prefix="demo_")
        print(format_results_for_readme(tables))
        return tables
    tables = create_article_tables_from_results(results_dir)
    if not tables:
        print(f"No result artifacts found in {results_dir}")
    else:
        print(format_results_for_readme(tables))
    return tables


if __name__ == "__main__":
    main()
