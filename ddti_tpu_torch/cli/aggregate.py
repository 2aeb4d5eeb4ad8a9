"""Sweep-results aggregator, ported from ``ddti_tpu/cli/aggregate.py``.

It scans an experiments tree (one ``<ModelType>_<timestamp>/`` run
directory per sweep job, as the port's ``Config.make_dirs`` creates
them), pulls each run's configuration snapshot and test metrics, and
prints one ranked summary table, the JAX tool's, and optionally its CSV.

Metrics come from ``result/test_metrics.json`` (written by
``Trainer.test``); where it is missing, the last "Test Metrics" block in
``log/train_log.log`` is parsed instead.

  python -m ddti_tpu_torch.cli.aggregate --experiments_dir experiments \
      [--output summary.csv] [--sort iou]
"""

from __future__ import annotations

import argparse
import json
import os
import re

# knobs worth a column in the summary (subset of the config snapshot)
_CONFIG_COLS = ("model_type", "base_filters", "depth", "image_size",
                "batch_size", "lr", "use_elastic", "use_speckle", "use_tgc",
                "use_clahe", "use_mixup", "tta")
_METRIC_COLS = ("iou", "f1", "precision", "recall", "acc", "hd95_mean",
                "assd_mean", "threshold", "total_images")
# metrics where LOWER is better (surface distances) — sorted ascending
_ASCENDING = {"hd95_mean", "assd_mean"}

_LOG_RE = re.compile(
    r"ACC=([\d.]+), Precision=([\d.]+), Recall=([\d.]+), "
    r"F1=([\d.]+), IoU=([\d.]+)")


def _metrics_from_json(run_dir: str):
    path = os.path.join(run_dir, "result", "test_metrics.json")
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _metrics_from_log(run_dir: str):
    """Fallback: the LAST 'Test Metrics' block in the run log."""
    path = os.path.join(run_dir, "log", "train_log.log")
    if not os.path.isfile(path):
        return None
    try:
        with open(path, errors="replace") as f:
            matches = _LOG_RE.findall(f.read())
    except OSError:
        return None
    if not matches:
        return None
    acc, precision, recall, f1, iou = (float(x) for x in matches[-1])
    return {"acc": acc, "precision": precision, "recall": recall,
            "f1": f1, "iou": iou}


def _config_snapshot(run_dir: str) -> dict:
    path = os.path.join(run_dir, "config.yaml")
    if not os.path.isfile(path):
        return {}
    try:
        import yaml
        with open(path) as f:
            return yaml.safe_load(f) or {}
    except Exception:
        return {}


def collect_runs(experiments_dir: str) -> list[dict]:
    """One summary row per run directory that has test metrics."""
    rows = []
    for name in sorted(os.listdir(experiments_dir)):
        run_dir = os.path.join(experiments_dir, name)
        if not os.path.isdir(run_dir):
            continue
        metrics = _metrics_from_json(run_dir) or _metrics_from_log(run_dir)
        if metrics is None:
            continue
        cfg = _config_snapshot(run_dir)
        # model shape knobs live inside the model_kwargs sub-dict of the
        # snapshot; flatten them for the column lookup
        cfg = {**cfg.get("model_kwargs", {}), **cfg}
        row = {"run": name}
        for k in _CONFIG_COLS:
            row[k] = cfg.get(k, metrics.get(k, ""))
        for k in _METRIC_COLS:
            v = metrics.get(k, "")
            row[k] = round(float(v), 4) if v != "" else ""
        rows.append(row)
    return rows


def format_table(rows: list[dict], columns: list[str]) -> str:
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in columns}
    lines = ["  ".join(c.ljust(widths[c]) for c in columns),
             "  ".join("-" * widths[c] for c in columns)]
    for r in rows:
        lines.append("  ".join(str(r.get(c, "")).ljust(widths[c])
                               for c in columns))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiments_dir", default="experiments")
    ap.add_argument("--output", default=None,
                    help="also write the summary as CSV")
    ap.add_argument("--sort", default="iou", choices=_METRIC_COLS,
                    help="metric column to rank by (descending)")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.experiments_dir):
        print(f"no experiments directory at {args.experiments_dir}")
        return 1
    rows = collect_runs(args.experiments_dir)
    if not rows:
        print(f"no runs with test metrics under {args.experiments_dir}")
        return 1
    sign = 1.0 if args.sort in _ASCENDING else -1.0
    rows.sort(key=lambda r: (r.get(args.sort) == "",
                             sign * (r.get(args.sort) or 0.0)))

    columns = ["run", *_CONFIG_COLS, *_METRIC_COLS]
    print(format_table(rows, columns))

    if args.output:
        import csv
        with open(args.output, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=columns)
            w.writeheader()
            w.writerows(rows)
        print(f"\nwrote {len(rows)} rows to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
