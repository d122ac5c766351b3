"""Article-style results tables (``tpuhar/report/tables.py``), copied so that the port
imports nothing of the JAX package: few-shot pivot tables ("mean ± std" per sample count,
Table 3), zero-shot (Table 4, from ``zeroshot_results.json``), ablations (Table 5, from
``ablation_results.csv``), probe against finetune, the OOD table, each saved as CSV,
booktabs LaTeX and Markdown; the README block and a synthetic demo. Host pandas only,
imported by the functions that use it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np


def format_mean_std(mean: float, std: float, decimals: int = 2) -> str:
    import pandas as pd

    if pd.isna(std):
        return f"{mean:.{decimals}f}"
    return f"{mean:.{decimals}f} ± {std:.{decimals}f}"


class TableGenerator:
    """Builds and saves article-style tables from result artifacts."""

    def __init__(self, results_dir):
        self.results_dir = Path(results_dir)
        self.results_dir.mkdir(parents=True, exist_ok=True)

    # -- Table 3: few-shot ----------------------------------------------------------
    def generate_table3_style(
        self, results_df: pd.DataFrame, metric: str = "balanced_accuracy"
    ) -> pd.DataFrame:
        """Few-shot pivot: rows (experiment, mode), columns n_samples, cells mean±std."""
        agg = (
            results_df.groupby(["experiment", "n_samples", "mode"])[metric]
            .agg(["mean", "std"])
            .reset_index()
        )
        agg["formatted"] = agg.apply(
            lambda r: format_mean_std(r["mean"], r["std"]), axis=1
        )
        table = agg.pivot_table(
            index=["experiment", "mode"],
            columns="n_samples",
            values="formatted",
            aggfunc="first",
        )
        table.columns = [f"{c} samples" for c in table.columns]
        return table

    # -- Table 4: zero-shot ---------------------------------------------------------
    def generate_table4_style(self, zeroshot_results: Dict) -> pd.DataFrame:
        """Zero-shot metrics table from a ``{method: {metric: value}}`` dict
        (the reference reads ``zeroshot_results.json``)."""
        import pandas as pd

        return pd.DataFrame(zeroshot_results).T

    # -- Table 5: ablations ---------------------------------------------------------
    def generate_table5_style(self, ablation_df: pd.DataFrame) -> pd.DataFrame:
        """Ablation table: one row per configuration with its metrics."""
        if "config" in ablation_df.columns:
            return ablation_df.set_index("config")
        return ablation_df

    # -- probe vs finetune ----------------------------------------------------------
    def create_comparison_table(
        self, results_df: pd.DataFrame, metric: str = "balanced_accuracy"
    ) -> pd.DataFrame:
        """Probe-vs-finetune comparison across sample counts with deltas."""
        agg = (
            results_df.groupby(["n_samples", "mode"])[metric].mean().unstack("mode")
        )
        if {"linear_probe", "finetune"} <= set(agg.columns):
            agg["delta"] = agg["finetune"] - agg["linear_probe"]
        return agg

    # -- persistence ----------------------------------------------------------------
    def save_tables(self, tables: Dict[str, pd.DataFrame], prefix: str = "") -> Dict[str, list]:
        """Save each table as CSV + LaTeX + Markdown (``generate_tables.py:161-199``)."""
        written: Dict[str, list] = {}
        for name, df in tables.items():
            stem = f"{prefix}{name}"
            paths = []
            for suffix, writer in (
                (".csv", lambda p: df.to_csv(p)),
                (".tex", lambda p: p.write_text(create_latex_paper_table(df, caption=name))),
                (".md", lambda p: df.to_markdown(p)),
            ):
                p = self.results_dir / f"{stem}{suffix}"
                writer(p)
                paths.append(str(p))
            written[name] = paths
        return written


def create_article_tables_from_results(results_dir, output_dir=None) -> Dict[str, pd.DataFrame]:
    """Assemble every available table from standard result artifacts
    (``generate_tables.py:202-335``): ``fewshot_results_raw.csv`` → Table 3,
    ``zeroshot_results.json`` → Table 4, ``ablation_results.csv`` → Table 5.
    Missing artifacts are skipped, not fatal."""
    import pandas as pd

    results_dir = Path(results_dir)
    gen = TableGenerator(output_dir or results_dir)
    tables: Dict[str, pd.DataFrame] = {}

    fewshot = results_dir / "fewshot_results_raw.csv"
    if fewshot.exists():
        df = pd.read_csv(fewshot)
        try:
            tables["table3_fewshot"] = gen.generate_table3_style(df)
            tables["comparison_probe_vs_finetune"] = gen.create_comparison_table(df)
        except Exception as e:  # malformed artifact → skip, like the reference
            print(f"[tables] Table 3 failed: {e}")

    zeroshot = results_dir / "zeroshot_results.json"
    if zeroshot.exists():
        try:
            tables["table4_zeroshot"] = gen.generate_table4_style(
                json.loads(zeroshot.read_text())
            )
        except Exception as e:
            print(f"[tables] Table 4 failed: {e}")

    ablation = results_dir / "ablation_results.csv"
    if ablation.exists():
        try:
            tables["table5_ablation"] = gen.generate_table5_style(pd.read_csv(ablation))
        except Exception as e:
            print(f"[tables] Table 5 failed: {e}")

    ood = results_dir / "ood_results.csv"
    if ood.exists():
        try:
            tables["table_ood"] = pd.read_csv(ood).set_index(
                pd.read_csv(ood).columns[0]
            )
        except Exception as e:
            print(f"[tables] OOD table failed: {e}")

    if tables:
        gen.save_tables(tables)
    return tables


def create_latex_paper_table(df: pd.DataFrame, caption: str = "", label: str = "") -> str:
    """Booktabs LaTeX table (``generate_tables.py:338-397``)."""
    body = df.to_latex(escape=True)
    # upgrade rules to booktabs style
    body = (
        body.replace("\\hline", "\\midrule")
        .replace("\\toprule", "\\toprule")
    )
    label = label or caption.replace(" ", "_").lower()
    return (
        "\\begin{table}[ht]\n\\centering\n"
        + body
        + (f"\\caption{{{caption}}}\n" if caption else "")
        + (f"\\label{{tab:{label}}}\n" if label else "")
        + "\\end{table}\n"
    )


def format_results_for_readme(tables: Dict[str, pd.DataFrame]) -> str:
    """Markdown summary block for a README (``generate_tables.py:400-420``)."""
    parts = []
    for name, df in tables.items():
        parts.append(f"### {name}\n")
        parts.append(df.to_markdown())
        parts.append("")
    return "\n".join(parts)


def make_demo_results(seed: int = 0) -> pd.DataFrame:
    """Synthetic few-shot results for exercising the table pipeline without training
    (the reference's only synthetic harness, ``generate_tables.py:423-491``)."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    rows = []
    for exp in ["imu_only", "cross_modal", "cross_modal_ft"]:
        for n in [10, 20, 50, 100]:
            for mode in ["linear_probe", "finetune"]:
                base = 40 + 10 * np.log10(n) + (5 if mode == "finetune" else 0)
                base += {"imu_only": 0, "cross_modal": 4, "cross_modal_ft": 7}[exp]
                for run in range(5):
                    acc = base + rng.normal(0, 1.5)
                    rows.append(
                        {
                            "experiment": exp,
                            "n_samples": n,
                            "run": run,
                            "mode": mode,
                            "accuracy": acc,
                            "balanced_accuracy": acc - rng.uniform(0, 2),
                            "f1_macro": acc - rng.uniform(0, 3),
                        }
                    )
    return pd.DataFrame(rows)
