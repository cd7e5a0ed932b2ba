"""What a run imports, checked in fresh processes: a traced run of each
driver (tiny cells on the CPU, every metric reader) loads no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared
whole: the port's name begins with the JAX package's), and the plain
reference loads nothing of the port. The command line prints no result
where it finds no card, nor in a directory holding only the benchmark."""
import json
import os
import shutil
import subprocess
import sys

from bench.lib import common

ROOT = str(common.ROOT)


def _python(code: str, cwd: str = ROOT, timeout: int = 240) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, timeout=timeout,
                          capture_output=True, text=True)


def test_a_run_of_every_driver_loads_no_jax_and_no_reference_package():
    code = f"""
import sys, json
sys.path[:0] = [{ROOT!r}]
from bench.tests import tiny_cells as T
from bench.run import run_job
from bench.lib import common
man = common.manifest()
for name, files in (("zcode-train-gd03", T.zcode_files()), ("dbrx-serve-conv", T.dbrx_files())):
    r = run_job(T.job(name, files, seconds=0.3, trace=1), man)
    assert r["metrics"], r
print(json.dumps({{"bad": common.forbidden_modules(),
                  "port": "repro_torch" in sys.modules}}))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "port": True}


def test_the_reference_loads_nothing_of_the_port():
    code = f"""
import sys, json
sys.path[:0] = [{ROOT!r}]
import bench.reference.model, bench.reference.train, bench.reference.gate_drop
import bench.lib.weights, bench.lib.traffic, bench.lib.flops
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        & {{"repro_torch", "repro", "jax", "jaxlib", "flax"}})))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def _cli(cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "zcode-train-gd03",
                           "--seed", str((1 << 31) + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, timeout=240, capture_output=True, text=True)


def test_no_card_and_no_program_give_no_result(tmp_path):
    r = _cli(ROOT)
    assert r.returncode != 0 and not r.stdout.strip()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _cli(str(tmp_path))
    assert r.returncode != 0 and not r.stdout.strip()
