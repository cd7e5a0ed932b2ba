"""B5 and B6 (``kernels/flash_decode.py``) at hymba-1.5b's decode shape on
the card: 25 query heads over 5 kv heads of 64 (rep 5, not a power of
two), every index past the hybrid's 128 meta positions, against their
plain versions; skip without a card. This file imports no JAX, so it runs
where the card is (``--noconftest``); the model's CPU tests against the
reference are ``test_torch_hybrid.py``.

Tolerances: f32 within 1e-4 abs + 1e-4 rel (sums in another order), bf16
caches within 1e-2 + 1.6e-2 (about two bf16 ulps); B6 bitwise B5.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def _hymba_case(g, b, s, dev, kvdt):
    """q (b, 25, 64) f32 and a (b, s, 5, 64) cache, as hymba's global
    layers read them."""
    q = torch.randn(b, 25, 64, generator=g).to(dev)
    k, v = (torch.randn(b, s, 5, 64, generator=g).to(dev, kvdt) for _ in range(2))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_at_hymba_shape_matches_plain(kvdt):
    """B5 at rep 5 (not a power of two), hd 64: caches of 160 (one split)
    and 2,208 positions (128 meta + a 2,048-token prompt + 32; several
    splits), every index past the 128 meta positions, per row (one at the
    first prompt position, split edges, the last) and scalar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(11)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, s in ((8, 160), (4, 2208)):
        q, k, v = _hymba_case(g, b, s, dev, kvdt)
        n, per = FD.split_plan(s, b, 5, sms)
        assert (n > 1) == (s > 192)
        rows = [128, min(per - 1, s - 1), min(per, s - 1), s - 1] * 2
        for idx in (torch.tensor(rows[:b], device=dev), 128 + (s - 129) // 2):
            out = FD.flash_decode(q, k, v, idx)
            want = ref.flash_decode_ref(q, k, v, idx)
            atol, rtol = (1e-4, 1e-4) if kvdt == torch.float32 else (1e-2, 1.6e-2)
            torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("kvdt", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_paged_at_hymba_shape_matches_plain_and_b5(kvdt):
    """B6 at the same shape over pages of 16 in a seeded permutation (the
    first 8 pages, the meta positions, shared by every row as the prefix
    cache shares them): against its plain version and bitwise B5 on the
    contiguous cache its tables address."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(12)
    b, ps, nb = 4, 16, 14                       # 224 positions: 128 meta + 96
    q, kc, vc = _hymba_case(g, b, nb * ps, dev, kvdt)
    perm = torch.randperm(b * nb, generator=g)
    tables = perm.view(b, nb).clone()
    tables[:, :8] = tables[0, :8]               # the shared meta pages
    kc[:, :128] = kc[:1, :128]
    vc[:, :128] = vc[:1, :128]
    n_pages = b * nb
    ka = torch.zeros((n_pages + 1, ps, 5, 64), dtype=kvdt, device=dev)
    va = torch.zeros_like(ka)
    for r in range(b):
        ka[tables[r].to(dev)] = kc[r].view(nb, ps, 5, 64)
        va[tables[r].to(dev)] = vc[r].view(nb, ps, 5, 64)
    bt = tables.to(dev, torch.int32)
    idx = torch.tensor([128, 150, 191, nb * ps - 1], device=dev)
    out = FD.flash_decode_paged(q, ka, va, bt, idx)
    want = ref.flash_decode_paged_ref(q, ka, va, bt, idx)
    atol, rtol = (1e-4, 1e-4) if kvdt == torch.float32 else (1e-2, 1.6e-2)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
    assert torch.equal(out, FD.flash_decode(q, kc, vc, idx))
