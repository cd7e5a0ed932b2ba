"""Cells of the benchmark cut to a size the CPU runs in seconds (d 64, two
layers a stack, a few experts) and computed in float32, where the program
rounds nothing the reference does not, with the drivers, the reference,
the metric readers and the cells' own limits as they are: for the tests on
the CPU. (At this size bf16 routing flips read far above the full-size
readings the limits are set from.)"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.lib import common  # noqa: E402

SEED = (1 << 31) + 977


def zcode_files():
    f = common.cell_files("zcode-train-gd03")
    c = f["config"]
    c.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
             vocab=512, max_seq=64, dtype="float32")
    c["encoder"].update(n_layers=2, seq=64)
    c["moe"].update(n_experts=4)
    c["train"].update(warmup_steps=50)
    f["traffic"].update(tokens_per_side=64, row_multiple=2, buckets=[8, 12, 16],
                        length={"median": 6, "sigma": 0.5, "min": 2, "max": 14}, n_langs=4)
    f["cell"].update(setup_steps=4, profile_steps=1)
    return f


def dbrx_files(cell="dbrx-serve-conv"):
    f = common.cell_files(cell)
    c = f["config"]
    c.update(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16, d_ff=96,
             vocab=300, max_seq=128, dtype="float32", param_dtype="float32")
    c["moe"].update(n_experts=8, d_ff_expert=96)
    f["traffic"].update(rate=40.0, block=8,
                        prompt={"min": 3, "max": 12, "median": 6, "sigma": 0.5},
                        output={"min": 4, "max": 10, "median": 6, "sigma": 0.35})
    f["cell"]["system"].update(slots=4, buckets=[4, 8, 12], admit_width=2, cache_len=32)
    f["cell"].update(profile_ticks=3, check_requests=3, prime_s=0.2, drain_s=20)
    return f


def job(name, files, *, seconds=1.0, trace=0, seed=SEED):
    import torch
    from bench.run import Job
    return Job(name, seed, seconds, trace, copy.deepcopy(files), common.Clock(),
               torch.device("cpu"), files["cell"]["chips"])
