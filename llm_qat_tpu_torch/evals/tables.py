"""Result table generation (ASCII / Markdown / LaTeX).

Re-implements the reference `ResultTableGenerator`
(`part3_eval_sp/generate_tables.py:31-215`, cpt copy identical): Table 1
zero-shot (sorted by Avg desc), Table 2 perplexity (sorted by WikiText2 asc),
Table 7 few-shot (MMLU/TriviaQA placeholder), plus LaTeX and Markdown export.
Implemented dependency-free (the reference falls back from `tabulate`).

Counterpart of `llm_qat_tpu/evals/tables.py`: pure Python, the same code.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional


def _ascii_table(rows: List[Dict], headers: List[str]) -> str:
    def fmt(v):
        if isinstance(v, float):
            return f"{v:.1f}"
        return str(v)

    widths = {h: len(h) for h in headers}
    for r in rows:
        for h in headers:
            widths[h] = max(widths[h], len(fmt(r.get(h, ""))))
    sep = "+" + "+".join("-" * (widths[h] + 2) for h in headers) + "+"
    out = [sep, "|" + "|".join(f" {h:<{widths[h]}} " for h in headers) + "|", sep]
    for r in rows:
        out.append(
            "|" + "|".join(f" {fmt(r.get(h, '')):<{widths[h]}} " for h in headers) + "|"
        )
    out.append(sep)
    return "\n".join(out)


def _markdown_table(rows: List[Dict], headers: List[str]) -> str:
    def fmt(v):
        return f"{v:.1f}" if isinstance(v, float) else str(v)

    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        out.append("| " + " | ".join(fmt(r.get(h, "")) for h in headers) + " |")
    return "\n".join(out)


def _latex_table(rows: List[Dict], headers: List[str], caption: str) -> str:
    def fmt(v):
        return f"{v:.1f}" if isinstance(v, float) else str(v)

    cols = "l" * len(headers)
    lines = [
        "\\begin{table}[h]", "\\centering", f"\\caption{{{caption}}}",
        f"\\begin{{tabular}}{{{cols}}}", "\\toprule",
        " & ".join(headers) + " \\\\", "\\midrule",
    ]
    for r in rows:
        lines.append(" & ".join(fmt(r.get(h, "")) for h in headers) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}", "\\end{table}"]
    return "\n".join(lines)


class ResultTableGenerator:
    """`results` = {config_name: {bits, model_size_gb, zero_shot, perplexity}}"""

    def __init__(self, results: Dict, output_dir: Optional[str] = None):
        self.results = results
        self.output_dir = Path(output_dir) if output_dir else None

    def _save(self, text: str, filename: str):
        if self.output_dir:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            (self.output_dir / filename).write_text(text)

    def _zero_shot_rows(self):
        all_tasks = set()
        for result in self.results.values():
            if result.get("zero_shot"):
                all_tasks.update(
                    k for k in result["zero_shot"] if k != "Average"
                )
        task_names = sorted(all_tasks)
        rows = []
        for name, result in self.results.items():
            zs = result.get("zero_shot")
            if not zs:
                continue
            row = {"Method": name, "#Bits": result.get("bits", "N/A"),
                   "Size(GB)": result.get("model_size_gb", 0)}
            for t in task_names:
                row[t] = zs.get(t, 0)
            row["Avg"] = zs.get("Average", 0)
            rows.append(row)
        rows.sort(key=lambda r: r.get("Avg", 0), reverse=True)
        headers = ["Method", "#Bits", "Size(GB)"] + task_names + ["Avg"]
        return rows, headers

    def generate_table_1_zero_shot(self, fmt: str = "ascii") -> str:
        rows, headers = self._zero_shot_rows()
        if not rows:
            return "No zero-shot results available"
        body = {"ascii": _ascii_table, "markdown": _markdown_table}.get(
            fmt, _ascii_table
        )(rows, headers)
        table = "Table 1: Zero-shot Common Sense Performance (↑)\n" + "=" * 100 + "\n" + body
        self._save(table, "table1_zero_shot.txt")
        return table

    def generate_table_2_perplexity(self, fmt: str = "ascii") -> str:
        rows = []
        for name, result in self.results.items():
            ppl = result.get("perplexity")
            if not ppl:
                continue
            row = {"Method": name, "#Bits": result.get("bits", "N/A")}
            for ds, v in ppl.items():
                row[ds + "↓"] = v
            rows.append(row)
        if not rows:
            return "No perplexity results available"
        sort_key = next((h for h in rows[0] if h.startswith("WikiText2")), None)
        if sort_key:
            rows.sort(key=lambda r: r.get(sort_key, float("inf")))
        headers = list(rows[0].keys())
        body = {"ascii": _ascii_table, "markdown": _markdown_table}.get(
            fmt, _ascii_table
        )(rows, headers)
        table = "Table 2: Perplexity Results (↓)\n" + "=" * 50 + "\n" + body
        self._save(table, "table2_perplexity.txt")
        return table

    def generate_table_7_few_shot(self, fmt: str = "ascii") -> str:
        rows = []
        for name, result in self.results.items():
            fs = result.get("few_shot")
            if not fs:
                continue
            mmlu = fs.get("MMLU", {})
            rows.append({
                "Method": name,
                "MMLU-Hum": mmlu.get("Humanities", 0),
                "MMLU-STEM": mmlu.get("STEM", 0),
                "MMLU-Social": mmlu.get("Social Sciences", 0),
                "MMLU-Other": mmlu.get("Other", 0),
                "MMLU-Avg": mmlu.get("Average", 0),
                "TriviaQA": fs.get("TriviaQA", 0),
            })
        if not rows:
            return "No few-shot results available"
        rows.sort(key=lambda r: r.get("MMLU-Avg", 0), reverse=True)
        headers = list(rows[0].keys())
        table = ("Table 7: Few-shot Performance (↑)\n" + "=" * 80 + "\n"
                 + _ascii_table(rows, headers))
        self._save(table, "table7_few_shot.txt")
        return table

    def export_to_latex(self) -> Dict[str, str]:
        out = {}
        rows, headers = self._zero_shot_rows()
        if rows:
            out["zero_shot"] = _latex_table(
                rows, headers, "Zero-shot Common Sense Performance"
            )
            self._save(out["zero_shot"], "zero_shot_table.tex")
        return out
