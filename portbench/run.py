"""Runs one cell of the port's benchmark from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The program under test is ``src/repro_torch`` of the same checkout; its
CUDA libraries build into ``build/repro_torch_kernels`` there on the first
run and are reused after. See ``portbench/harness/cli.py``.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness.cli import main

    sys.exit(main())
