"""The readings that set each compared number's upper end: the control
(the plain reference in the program's place, one precision below the
configuration's) and the planted faults, at a cell's own size, on several
seeds, with no measured window and without the program.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--out FILE]

Each cell's drive (``drives/<drive>.py``) says what its control and faults
are, in its ``control_readings``: a training cell's control is the
reference with bfloat16 tables, its faults a step that leaves the tables
unchanged (read by the measure itself: every change reads 1) and a step
that leaves out half the batch, its loss the mean over the rest; a merge
cell's control is the reference with TF32 matrix products, its fault one
row of the merged table altered where it is produced. Each line printed is
one JSON object: the cell, the seed, the variant and the readings of every
compared number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(spec, workload: str, seed: int, device) -> dict:
    """``{variant: readings}`` of one cell by its drive's ``control_readings``."""
    cell = spec.cell(workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    return spec.drive(traffic).control_readings(config, traffic, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, action="append")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness.spec import Spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    spec = Spec.load()
    name = torch.cuda.get_device_name(device)
    for workload in args.workload:
        for seed in (int(s) for s in args.seeds.split(",")):
            for variant, r in readings(spec, workload, seed, device).items():
                line = json.dumps({"workload": workload, "seed": seed, "variant": variant,
                                   "readings": r, "device": name})
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
