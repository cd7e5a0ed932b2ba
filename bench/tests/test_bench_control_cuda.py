"""The control on the card at a size a test run holds: the reference put in
the program's place in a lower precision (float8 e4m3 activations, and the
weights where they are bf16: the step below the bf16 the configurations
state) fails a cell's limits, where the program passes them. The published
widths with fewer layers, a smaller batch and a lower rate."""
import pytest

from bench.lib import common
from bench.run import run_job

pytestmark = pytest.mark.cuda
MAN = common.manifest()


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch


def _job(name, files, seconds=3.0):
    from bench.run import Job
    torch = _card()
    return Job(name, (1 << 31) + 4242, seconds, 0, files, common.Clock(),
               torch.device("cuda", 0), 1)


def test_training_control_fails_where_the_program_passes():
    files = common.cell_files("zcode-train-gd03")
    files["config"].update(n_layers=2)
    files["config"]["encoder"].update(n_layers=4)
    files["traffic"].update(tokens_per_side=4096)
    drv = common.load_module(common.BENCH / "drivers" / "train.py")
    assert run_job(_job("zcode-train-gd03", files), MAN)["correct"]
    limits = files["cell"]["limits"]
    assert not common.passes(common.judge(drv.control(_job("zcode-train-gd03", files),
                                                      kind="fp8"), limits))


def test_serving_control_fails_where_the_program_passes():
    files = common.cell_files("dbrx-serve-conv")
    files["config"].update(n_layers=3)
    files["traffic"].update(rate=1.0)
    files["cell"].update(prime_s=3)
    files["cell"]["system"].update(slots=8)
    drv = common.load_module(common.BENCH / "drivers" / "serve_open.py")
    job = _job("dbrx-serve-conv", files, seconds=8.0)
    job.control = "fp8"
    out = drv.run(job)
    limits = files["cell"]["limits"]
    assert common.passes(common.judge(out["numbers"], limits))
    assert not common.passes(common.judge(out["control"], limits))
