"""B5's address check (``REPRO_SMEM_CHECK``, ``kernels/csrc/flash_decode.cu``)
on the card, and the two kernel forms it was built to examine; skip
without a card. This file imports no JAX, so it runs where the card is
(``--noconftest``).

Each case builds a copy of the flash-decode source with one edit into a
temporary directory (``flash_decode.cu`` and ``errors.cu``, the library a
child process loads in place of the port's; all copies build at once, in
a module fixture) and runs its launches in a child process, since a
trapped kernel costs its process the CUDA context. The child prints what
it saw as JSON: whether a launch failed, the check's record, the largest
error against the plain version.

- The check as it stands: hymba-1.5b's shape (25 query heads over 5 kv
  heads of 64) on a 192-position cache, every index from 150 to 191, bf16
  and f32 caches (tensor-core and CUDA-core bodies): no record, outputs
  within tolerance (f32 1e-4 + 1e-4 rel., bf16 cache 1e-2 + 1.6e-2).
- Positive controls: the check of one access moved past its region (the
  zeroed V rows past the shared memory; the copies' cache reads past the
  cache) traps and names that access.
- The two kernel forms that went wrong on the card (ROADMAP C): the
  V-row zeroing as one flat loop over rows x chunks, and the CUDA-core
  body's position loops unrolled by 2. Under CUDA 12.8's ptxas the first stores past the shared memory and
  the second counts one row a warp (the note at
  ``csrc/flash_decode.cu::warp_rows``). A toolkit without that miscompile
  runs both right, so the tests hold only what the check promises either
  way: a fault is named at the zeroed V rows, past the shared memory; the
  unrolled loops' wrong outputs come with no out-of-range access.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ZERO = """          if (r >= rows) {
            check_shared(a, vbase + r * geo.pstride + lane * 16, 16, kSiteZeroV);"""
ZERO_PAST = """          if (r >= rows) {
            check_shared(a, vbase + r * geo.pstride + lane * 16 + kStages * geo.stage_bytes, 16,
                         kSiteZeroV);"""
ZERO_LOOP = """      if (lane < geo.chunks) {
#pragma unroll
        for (int r = 0; r < kMmaRows; ++r) {
          if (r >= rows) {
            check_shared(a, vbase + r * geo.pstride + lane * 16, 16, kSiteZeroV);
            *reinterpret_cast<uint4*>(vbase + r * geo.pstride + lane * 16) =
                make_uint4(0, 0, 0, 0);
          }
        }
      }"""
FLAT_LOOP = """      for (int i = lane; i < (kMmaRows - rows) * geo.chunks; i += 32) {
        const int r = rows + i / geo.chunks, c = i % geo.chunks;
        check_shared(a, vbase + r * geo.pstride + c * 16, 16, kSiteZeroV);
        *reinterpret_cast<uint4*>(vbase + r * geo.pstride + c * 16) = make_uint4(0, 0, 0, 0);
      }"""
COPY = "(kv ? vb : kb) + row + c * W,"
COPY_PAST = "(kv ? vb : kb) + row + c * W + cache_bytes<TKV, kPaged>(a),"
ROLLED = "#pragma unroll 1\n"
# variant -> its edits of flash_decode.cu (each old string found exactly
# once, or as often as it stands for the rolled loops)
VARIANTS = {"as_is": [], "zero_past": [(ZERO, ZERO_PAST)], "copy_past": [(COPY, COPY_PAST)],
            "flat": [(ZERO_LOOP, FLAT_LOOP)], "unrolled": [(ROLLED, "#pragma unroll 2\n")]}

# the child: loads the copy's library, runs hymba's shape over the indices
# named, synchronises after each launch, prints one JSON line
CHILD = r"""
import json, sys
from pathlib import Path
import torch
from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_decode as FD
build.CSRC, build.BUILD_ROOT = Path(sys.argv[1]), Path(sys.argv[2])
kvdt = getattr(torch, sys.argv[3])
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
q = torch.randn(8, 25, 64, generator=g, device=dev)
k, v = (torch.zeros(8, 192, 5, 64, device=dev, dtype=kvdt) for _ in range(2))
k[:, :170] = torch.randn(8, 170, 5, 64, generator=g, device=dev).to(kvdt)
v[:, :170] = torch.randn(8, 170, 5, 64, generator=g, device=dev).to(kvdt)
atol, rtol = (1e-4, 1e-4) if kvdt == torch.float32 else (1e-2, 1.6e-2)
out = {"faulted": False, "error": "", "record": None, "worst": 0.0}
for i in range(int(sys.argv[4]), int(sys.argv[5])):
    idx = torch.full((8,), i, dtype=torch.int32, device=dev)
    try:
        got = FD.flash_decode(q, k, v, idx)
        torch.cuda.synchronize()
    except Exception as e:
        out.update(faulted=True, error=f"index {i}: {type(e).__name__}: {e}"[:300])
        break
    want = ref.flash_decode_ref(q, k, v, idx)
    excess = ((got - want).abs() - atol - rtol * want.abs()).max().item()
    out["worst"] = max(out["worst"], excess)
out["record"] = FD.check_record()
print(json.dumps(out))
"""


def _copy(dst: Path, edits) -> Path:
    csrc = dst / "csrc"
    csrc.mkdir(parents=True)
    for f in build.CSRC.iterdir():
        if f.suffix == ".cuh" or f.name in ("flash_decode.cu", "errors.cu"):
            shutil.copy(f, csrc / f.name)
    fd = csrc / "flash_decode.cu"
    text = fd.read_text()
    for old, new in edits:
        assert text.count(old) == (2 if old == ROLLED else 1), old[:60]
        text = text.replace(old, new)
    fd.write_text(text)
    return csrc


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    """Each variant's (csrc, build root), all built with the check on, the
    builds started together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = dict(os.environ, REPRO_SMEM_CHECK="1", PYTHONPATH=str(SRC))
    out, procs = {}, []
    for name, edits in VARIANTS.items():
        root = tmp_path_factory.mktemp(name)
        out[name] = (_copy(root, edits), root / "kernels")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import sys; from pathlib import Path; "
             "from repro_torch.kernels import build; build.CSRC = Path(sys.argv[1]); "
             "build.BUILD_ROOT = Path(sys.argv[2]); build.build()", *map(str, out[name])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        log, _ = p.communicate()
        assert p.returncode == 0, log[-3000:]
    return out


def _run(variants, name, kvdt, first=150, stop=192) -> dict:
    csrc, root = variants[name]
    env = dict(os.environ, REPRO_SMEM_CHECK="1", PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", CHILD, str(csrc), str(root), kvdt, str(first),
                        str(stop)], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"{name} ({kvdt} cache, indices {first}-{stop - 1}): {res}")
    return res


@pytest.mark.cuda
def test_cuda_default_build_has_no_address_check():
    """The port's library (no REPRO_SMEM_CHECK) has no record to read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if os.environ.get(build.CHECK_ENV) == "1":
        pytest.skip("the suite runs under REPRO_SMEM_CHECK=1")
    from repro_torch.kernels import flash_decode
    with pytest.raises(build.KernelError, match="not supported"):
        flash_decode.check_record()


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt", ["bfloat16", "float32"])
def test_cuda_address_check_passes_the_kernel_as_it_stands(variants, kvdt):
    """Both grouped-query bodies at hymba's shape, every index whose last
    tile ends anywhere in the third: no launch fails, no record, every
    output within tolerance of the plain version."""
    res = _run(variants, "as_is", kvdt)
    assert not res["faulted"] and res["record"] is None, res
    assert res["worst"] <= 0, res


@pytest.mark.cuda
@pytest.mark.parametrize("name,site", [("zero_past", "tensor-core zeroed V row"),
                                       ("copy_past", "cp.async cache source")])
def test_cuda_address_check_names_an_access_out_of_range(variants, name, site):
    """Positive controls: a check moved past its region traps at once and
    its record names that access, lying past the region's extent."""
    res = _run(variants, name, "bfloat16", 168, 169)
    rec = res["record"]
    assert res["faulted"] and rec is not None, res
    assert rec["site"] == site and rec["offset"] + rec["bytes"] > rec["extent"], rec


@pytest.mark.cuda
def test_cuda_flat_zeroing_faults_only_where_the_check_says(variants):
    """The first form that went wrong, the flat zeroing loop, at hymba's
    shape: where it faults, the record names the zeroed V rows past the
    shared memory (CUDA 12.8: index 168, 9 live rows in warp 2 of the
    third tile); where it does not, its outputs are right."""
    res = _run(variants, "flat", "bfloat16")
    if res["faulted"]:
        rec = res["record"]
        assert rec is not None and rec["site"] == "tensor-core zeroed V row", res
        assert rec["offset"] + rec["bytes"] > rec["extent"], rec
    else:
        assert res["record"] is None and res["worst"] <= 0, res


@pytest.mark.cuda
def test_cuda_unrolled_position_loops_go_wrong_without_a_bad_address(variants):
    """The second form that went wrong, the CUDA-core body's position loops
    unrolled by 2, on an f32 cache: no launch fails and the check names no
    access, whatever its outputs (CUDA 12.8: far off, one row a warp
    counted)."""
    res = _run(variants, "unrolled", "float32")
    assert not res["faulted"] and res["record"] is None, res
