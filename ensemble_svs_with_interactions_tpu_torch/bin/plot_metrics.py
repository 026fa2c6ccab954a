"""Plot training curves from metrics.jsonl files.

Equivalent of the reference's utils/make_graph.py:1-94 (which regex-parses
stdout logs into seaborn loss curves); this framework's trainers write
structured ``metrics.jsonl``, so plotting reads that directly.  The
port's copy of the JAX package's ``bin/plot_metrics.py`` (``matplotlib``
imported only when it runs, with the Agg backend).

Usage: python -m ...bin.plot_metrics <exp_dir> [<exp_dir> ...]
       [--metric Loss] [--out graph.png]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def load_metrics(exp_dir: Path):
    rows = []
    path = exp_dir / "metrics.jsonl"
    for line in path.read_text().splitlines():
        if line.strip():
            rows.append(json.loads(line))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("exp_dirs", nargs="+")
    ap.add_argument("--metric", default="Loss")
    ap.add_argument("--out", default="metrics.png")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for exp in args.exp_dirs:
        exp = Path(exp)
        rows = load_metrics(exp)
        series = {}
        for r in rows:
            epoch = r.get("step", r.get("epoch"))
            for k, v in r.items():
                if k.endswith(args.metric):
                    series.setdefault(k, []).append((epoch, v))
        for k, pts in sorted(series.items()):
            pts.sort()
            ax.plot(
                [p[0] for p in pts],
                [p[1] for p in pts],
                label=f"{exp.name}:{k}",
            )
    ax.set_xlabel("epoch")
    ax.set_ylabel(args.metric)
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
