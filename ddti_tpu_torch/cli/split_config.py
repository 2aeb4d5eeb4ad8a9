"""Config-matrix splitter, ported from ``ddti_tpu/cli/split_config.py``
(the reference's ``config/cut.py``): reads a YAML list of ``{model:
{model_type, kwargs}}`` entries, groups them by model_type, and writes
``<out_dir>/<ModelType>/config<N>.yaml`` for each entry, byte for byte as
the JAX tool writes them.

    python -m ddti_tpu_torch.cli.split_config configs/config.yaml sweep_dir
"""

from __future__ import annotations

import os
import sys

import yaml


def split_config(input_file: str, out_dir: str = ".") -> dict[str, int]:
    with open(input_file, encoding="utf-8") as f:
        docs = yaml.safe_load(f)
    groups: dict[str, list] = {}
    for doc in docs or []:
        mtype = (doc.get("model") or {}).get("model_type")
        if not mtype:
            continue
        groups.setdefault(mtype, []).append(doc)
    written = {}
    for mtype, docs_list in groups.items():
        d = os.path.join(out_dir, mtype)
        os.makedirs(d, exist_ok=True)
        for idx, doc in enumerate(docs_list, start=1):
            with open(os.path.join(d, f"config{idx}.yaml"), "w",
                      encoding="utf-8") as out:
                yaml.safe_dump(doc, out, sort_keys=False)
        written[mtype] = len(docs_list)
        print(f"Wrote {len(docs_list)} files to '{d}'")
    return written


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("Usage: python -m ddti_tpu_torch.cli.split_config <config.yaml> "
              "[out_dir]")
        return 1
    split_config(argv[0], argv[1] if len(argv) > 1 else ".")
    return 0


if __name__ == "__main__":
    sys.exit(main())
