"""The port covers the JAX package: module for module (``src/repro`` against
``src/repro_torch``) and field for field in every config dataclass
(``dataclasses.fields``), up to a written set, each item with why it has
no counterpart. A module or field the reference gains, or the port loses,
fails here until it is ported or written down.
"""
import dataclasses
import importlib
import os
import pkgutil

import pytest

pytest.importorskip("torch")

from conftest import SRC  # noqa: E402

# what the port lacks, and why
NO_COUNTERPART_MODULES = {
    "analysis/hlo.py": "walks XLA's compiled HLO text; eager PyTorch compiles no "
                       "program: the lint gate counts all-to-alls in comm.COUNTER",
    "analysis/jaxprs.py": "walks jaxprs and Pallas grid mappings; the port records aten "
                          "ops with a TorchDispatchMode (analysis/executables.py) and "
                          "kernel launches with torch.profiler",
    "launch/env.py": "XLA flags and tcmalloc for the JAX runtime, which the port does "
                     "not load",
    "kernels/platform.py": "Pallas interpret mode off the TPU; a port wrapper takes its "
                           "plain version on a CPU tensor",
}
NO_COUNTERPART_FIELDS = {
    ("ModelConfig", "scan_layers"): "lax.scan over a segment's layers; eager PyTorch "
                                    "runs each layer in turn",
    ("ModelConfig", "dropout"): "read by nothing in the reference",
    ("GatingDropoutConfig", "strategy"): "traced_cond vs host_cond jit strategies; "
                                         "eager PyTorch takes the drop bit as a host bool",
}


def _modules(pkg: str):
    root = os.path.join(SRC, pkg)
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files if f.endswith(".py")}


def test_every_module_has_a_counterpart():
    missing = _modules("repro") - _modules("repro_torch")
    assert missing == set(NO_COUNTERPART_MODULES)


def _config_classes(pkg: str):
    out = {}
    base = importlib.import_module(f"{pkg}.configs")
    mods = [base] + [importlib.import_module(f"{pkg}.configs.{m.name}")
                     for m in pkgutil.iter_modules(base.__path__)]
    for mod in mods:
        for name, obj in vars(mod).items():
            if isinstance(obj, type) and dataclasses.is_dataclass(obj) \
                    and obj.__module__.startswith(pkg + "."):
                out[name] = obj
    return out


def test_every_config_field_has_a_counterpart():
    ref, port = _config_classes("repro"), _config_classes("repro_torch")
    assert set(ref) <= set(port), sorted(set(ref) - set(port))
    assert "ModelConfig" in ref and "TrainConfig" in ref
    missing = {(name, f.name) for name, cls in ref.items() for f in dataclasses.fields(cls)
               if f.name not in {g.name for g in dataclasses.fields(port[name])}}
    assert missing == set(NO_COUNTERPART_FIELDS)


def test_the_written_set_names_real_gaps():
    """Every written module and field exists in the reference."""
    assert set(NO_COUNTERPART_MODULES) <= _modules("repro")
    ref = _config_classes("repro")
    for cls, field in NO_COUNTERPART_FIELDS:
        assert field in {f.name for f in dataclasses.fields(ref[cls])}
