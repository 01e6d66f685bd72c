"""Time chip_smoke.py in two checkouts, in turns (a, b, b, a), on the card:
each run's exit code and wall seconds, its output and its chip_smoke.json
kept under this repository's chiprun_out/ (turn{N}_{a|b}_smoke.*), the
four readings in chiprun_out/smoke_turns.json. Two commits are compared
inside one call, on one card; the first run of each checkout also builds
its kernels.

    python -m substratus_tpu_torch.tools.smoke_turns PARENT_DIR CHANGE_DIR [--phases card,build,...]
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[2] / "chiprun_out"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.tools.smoke_turns")
    ap.add_argument("a", help="checkout whose chip_smoke.py runs first and last")
    ap.add_argument("b", help="checkout whose chip_smoke.py runs second and third")
    ap.add_argument("--phases", default=None, help="chip_smoke.py's --phases (default: its default run)")
    args = ap.parse_args(argv)
    OUT_DIR.mkdir(exist_ok=True)
    cmd = [sys.executable, "chip_smoke.py"] + (["--phases", args.phases] if args.phases else [])
    runs = []
    for n, label in enumerate(("a", "b", "b", "a"), 1):
        tree = Path(getattr(args, label)).resolve()
        log = OUT_DIR / f"turn{n}_{label}_smoke.txt"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run(cmd, cwd=tree, stdout=f, stderr=subprocess.STDOUT).returncode
        runs.append({"run": n, "tree": label, "dir": str(tree), "rc": rc, "wall_s": time.perf_counter() - t0})
        report = tree / "chiprun_out" / "chip_smoke.json"
        if report.exists():
            shutil.copy(report, OUT_DIR / f"turn{n}_{label}_smoke.json")
        print(json.dumps(runs[-1]), flush=True)
    (OUT_DIR / "smoke_turns.json").write_text(json.dumps(runs, indent=1))
    return max(r["rc"] for r in runs)


if __name__ == "__main__":
    raise SystemExit(main())
