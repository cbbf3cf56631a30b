"""Offline dataset redirect (a copy of the JAX package's `data/offline.py`:
the same variable, fixture names and errors).

Every hub `load_dataset(...)` call of the calibration and prompt loaders
goes through `load_dataset` below. With `BITDISTILLER_DATA_DIR` set it
serves a JSONL fixture from that directory as a `datasets.Dataset`, so the
code downstream of the load runs as it would on hub data; unset, it calls
the hub loader. `datasets` is imported only inside the call.

Fixture naming: `<path>__<name>__<split>.jsonl`, with `/` in the hub path
replaced by `_` and `name=None` rendered as `default` (e.g.
`wikitext__wikitext-2-raw-v1__test.jsonl`). The repo's fixtures live in
`fixtures/`; `fixtures/README.md` gives their provenance.
"""

from __future__ import annotations

import json
import os

ENV_VAR = "BITDISTILLER_DATA_DIR"


def fixture_name(path: str, name: str | None, split: str | None) -> str:
    return f"{path.replace('/', '_')}__{name or 'default'}__{split}.jsonl"


def load_dataset(path: str, name: str | None = None, split: str | None = None, **kwargs):
    """Drop-in for datasets.load_dataset honoring BITDISTILLER_DATA_DIR."""
    data_dir = os.environ.get(ENV_VAR)
    if not data_dir:
        import datasets

        return datasets.load_dataset(path, name, split=split, **kwargs)
    fpath = os.path.join(data_dir, fixture_name(path, name, split))
    if not os.path.exists(fpath):
        raise FileNotFoundError(
            f"{ENV_VAR}={data_dir} is set but the fixture for "
            f"load_dataset({path!r}, {name!r}, split={split!r}) is missing: "
            f"expected {fpath}"
        )
    import datasets

    with open(fpath) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return datasets.Dataset.from_list(rows)
