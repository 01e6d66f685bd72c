"""Dataset-loader entry point of the port (port of
substratus_tpu/load/dataset.py), the container contract's dataset import:
source files into /content/artifacts, where a finetune later mounts them
read-only at /content/data.

    python -m substratus_tpu_torch.load.dataset [--out /content/artifacts] [--params /content/params.json]

params.json keys: ``urls`` (http(s) sources, each saved under the last
part of its path) and ``files`` (local paths to copy, for pre-mounted
volumes). Any other key exits, as in the port's other entry points.
"""
from __future__ import annotations

import argparse
import os
import shutil
import urllib.request

_SERVED = ("urls", "files")


def main(argv=None) -> int:
    from substratus_tpu_torch.serve.main import load_params_json

    ap = argparse.ArgumentParser(prog="python -m substratus_tpu_torch.load.dataset")
    ap.add_argument("--out", default="/content/artifacts")
    ap.add_argument("--params", default="/content/params.json")
    args = ap.parse_args(argv)

    p = load_params_json(args.params)
    for key in p:
        if key not in _SERVED:
            raise SystemExit(f"params.json: unknown key {key!r} (load.dataset takes {', '.join(_SERVED)})")
    os.makedirs(args.out, exist_ok=True)

    n = 0
    for url in p.get("urls", []):
        dest = os.path.join(args.out, os.path.basename(url.split("?")[0]))
        print(f"fetching {url} -> {dest}", flush=True)
        with urllib.request.urlopen(url, timeout=300) as r, open(dest, "wb") as f:
            shutil.copyfileobj(r, f)
        n += 1
    for path in p.get("files", []):
        shutil.copy(path, os.path.join(args.out, os.path.basename(path)))
        n += 1
    if n == 0:
        print("warning: no sources given (params.urls / params.files empty)")
    print(f"dataset artifact written: {n} files in {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
