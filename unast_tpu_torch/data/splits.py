"""Dataset splits of the port, copied from `unast_tpu/data/splits.py`: from
the 13,100-row LJSpeech manifest, 12,500 full_train / 12,300
unlabeled_train / 200 labeled_train / 300 val / 300 test.

The reference's exact split membership (which 200 utterances are
"labeled" defines the semi-supervised setup) ships as data in the port's
own `data/splits/*.csv`; `REFERENCE_SPLITS_DIR` points at them and is the
default when no on-disk splits dir exists. `make_splits` builds seeded
splits of other corpora."""

import os
from typing import Dict, List, Tuple

import numpy as np

#: The reference's exact split CSVs, a byte-for-byte copy of the JAX
#: package's unast_tpu/data/splits/*.csv.
REFERENCE_SPLITS_DIR = os.path.join(os.path.dirname(__file__), "splits")

SPLIT_SIZES = {"full_train": 12500, "unlabeled_train": 12300,
               "labeled_train": 200, "val": 300, "test": 300}


def make_splits(rows: List[Tuple[str, str]], seed: int = 0,
                sizes: Dict[str, int] = None) -> Dict[str, list]:
    """unast_tpu/data/splits.py::make_splits. rows: [(id, text)]. full_train is sampled first; labeled(200) and
    unlabeled(12300) partition it; val/test come from the remainder.
    Sizes scale down proportionally for smaller corpora."""
    sizes = dict(sizes or SPLIT_SIZES)
    n = len(rows)
    if n < sum((sizes["full_train"], sizes["val"], sizes["test"])):
        frac = n / 13100.0
        for k in sizes:
            sizes[k] = max(1, int(sizes[k] * frac))
        sizes["unlabeled_train"] = max(
            0, sizes["full_train"] - sizes["labeled_train"])
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    full = perm[:sizes["full_train"]]
    rest = perm[sizes["full_train"]:]
    labeled = full[:sizes["labeled_train"]]
    unlabeled = full[sizes["labeled_train"]:
                     sizes["labeled_train"] + sizes["unlabeled_train"]]
    val = rest[:sizes["val"]]
    test = rest[sizes["val"]:sizes["val"] + sizes["test"]]
    pick = lambda idx: [rows[int(i)] for i in idx]
    return {"full_train": pick(full), "labeled_train": pick(labeled),
            "unlabeled_train": pick(unlabeled), "val": pick(val),
            "test": pick(test)}


def write_splits(splits: Dict[str, list], out_dir: str):
    """unast_tpu/data/splits.py::write_splits: one `id|text|text` CSV per
    split under out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    for name, rows in splits.items():
        with open(os.path.join(out_dir, name + ".csv"), "w",
                  encoding="utf-8") as f:
            for fid, text in rows:
                f.write(f"{fid}|{text}|{text}\n")
