"""The integrator's kernels (``csrc/integrate.cu`` through
``core.integrate.initial_integrate`` and ``final_integrate``) on the card
against the plain torch chains on the same tensors, bit for bit: 2,000,000
rows (the spill cell's), a fifth of them frozen, one inverse mass or one a
row, with and without the wrap; one launch a call. Run it on a machine
with a CUDA device:
``python -m pytest tests/test_torch_integrate_card.py -m card``; without
one it skips."""

import pytest
import torch

from meso_tpu_torch.core import integrate
from meso_tpu_torch.core.box import Box
from meso_tpu_torch.kernels import _build
from test_torch_imports import one_torch_thread  # noqa: F401
from test_torch_row_kernels import INV_MASS, _motion


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.card
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("masses", list(INV_MASS))
def test_integrator_kernels_bitwise_on_the_card(wrap, masses):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    n = 2_000_000
    x, v, f, f2, image, move = (t.cuda() for t in _motion(n=n, seed=21))
    im = INV_MASS[masses](n).cuda()
    box = Box.cubic(6.0, device="cuda")
    dt, lam = 0.01, 0.65
    before = _build.LAUNCHES.copy()
    got = integrate.initial_integrate(x, v, f, image, box, dt, lam, im,
                                      move, wrap)
    v1 = integrate.final_integrate(v, f, f2, dt, im, move)
    assert _build.LAUNCHES - before == {"initial_integrate": 1,
                                        "final_integrate": 1}
    want = integrate.initial_integrate_plain(x, v, f, image, box, dt, lam,
                                             im, move, wrap)
    for name, a, b in zip(("x", "image", "v_tilde"), got, want):
        assert torch.equal(_bits(a), _bits(b)), name
    assert torch.equal(_bits(v1), _bits(integrate.final_integrate_plain(
        v, f, f2, dt, im, move)))
    assert bool(((x < 0) | (x >= 6.0)).any()) and bool((~move).any())
