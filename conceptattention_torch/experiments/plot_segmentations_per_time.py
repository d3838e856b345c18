"""Plot the timestep sweep's CSV (`experiments/per_timestep_segmentation.py`) as a
metric-vs-timestep line chart.

    python -m conceptattention_torch.experiments.plot_segmentations_per_time \\
        --csv per_timestep_metrics.csv --out per_timestep_metrics.png
"""

import argparse
import os
import sys
from typing import Optional, Sequence

from conceptattention_torch.utils.sweep_plots import plot_sweep_csv


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--csv", default="per_timestep_metrics.csv")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    out = args.out or os.path.splitext(args.csv)[0] + ".png"
    print("wrote", plot_sweep_csv(args.csv, out, x_col="timestep",
                                  title="Noise Timestep vs Segmentation Performance"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
