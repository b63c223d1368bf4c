"""Driver entry point: prints ONE JSON line with the headline metric
({"metric", "value", "unit", "vs_baseline"}) plus the nested per-config
suite. Implementation lives in gpupathtracer_tpu/bench.py."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gpupathtracer_tpu.bench import main, run_benchmark, run_scaling_probe  # noqa: F401

if __name__ == "__main__":
    main()
