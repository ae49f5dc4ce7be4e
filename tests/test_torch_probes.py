"""The port's TPU probes (meso_tpu_torch/probes/, T1-T4) against the JAX
tools' kernels run in interpret mode on the CPU, on the same inputs: T1
(``toy_dynroll``'s kernels, wrapped here in ``pallas_call(...,
interpret=True)`` as the tool calls them), T3 (all ten
``toy_tea_roll.run(variant, interpret=True)``) and T4 (``r5a_stage``'s
``null_pallas`` with its SMOKE setting) bitwise; T2 (``toy_mxu_tile``'s
four functions with ``interpret=True``) within the tool's own tolerance,
max |out - ref| / max |ref| < 1e-5. The tools are imported by path, here
only: the port never imports them."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import r5a_stage as j_r5a  # noqa: E402
import toy_dynroll as j_dynroll  # noqa: E402
import toy_mxu_tile as j_mxu  # noqa: E402
import toy_tea_roll as j_tea  # noqa: E402

from meso_tpu_torch.probes import (r5a_stage, toy_dynroll, toy_mxu_tile,
                                   toy_tea_roll)
from test_torch_imports import one_torch_thread  # noqa: F401


def _np(t):
    return t.cpu().numpy()


def _smem_call(kernel, shape, n_scal):
    return pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec((1, n_scal), memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.float32), interpret=True)


def test_t1_dynroll_and_cond_bitwise():
    (x0, offs), (x1, jm) = toy_dynroll.inputs("cpu")
    want = _smem_call(j_dynroll.k_dynroll, (8, toy_dynroll.L), 4)(
        jnp.asarray(_np(offs)), jnp.asarray(_np(x0)))
    np.testing.assert_array_equal(_np(toy_dynroll.dynroll(x0, offs)),
                                  np.asarray(want))
    want = _smem_call(j_dynroll.k_cond, (8, toy_dynroll.L), 2)(
        jnp.asarray(_np(jm)), jnp.asarray(_np(x1)))
    got = _np(toy_dynroll.cond(x1, jm))
    np.testing.assert_array_equal(got, np.asarray(want))
    # the second branch does not fire and the first does not accumulate
    np.testing.assert_array_equal(got, _np(x1 * 1 + x1 * 7))


@pytest.mark.parametrize("jm", [(2, 9), (9, 9), (2, 2)])
def test_t1_cond_either_branch_alone(jm):
    """A second taken branch starts again from the zero carries."""
    x = toy_dynroll.inputs("cpu")[1][0]
    jm_t = torch.tensor([jm], dtype=torch.int32)
    want = _smem_call(j_dynroll.k_cond, (8, toy_dynroll.L), 2)(
        jnp.asarray(_np(jm_t)), jnp.asarray(_np(x)))
    np.testing.assert_array_equal(_np(toy_dynroll.cond(x, jm_t)),
                                  np.asarray(want))


@pytest.mark.parametrize("name", ["dot_a", "dot_b", "tile", "dot_c"])
def test_t2_products_within_tool_tolerance(name):
    args = toy_mxu_tile.inputs(device="cpu")[name]
    want = np.asarray(getattr(j_mxu, name)(*(jnp.asarray(_np(a))
                                              for a in args),
                                            interpret=True))
    got = getattr(toy_mxu_tile, name)(*args)
    assert toy_mxu_tile.rel_err(got, torch.from_numpy(np.array(want))) < \
        toy_mxu_tile.TOL


def test_t2_batched_tile_is_each_tile():
    """A batch of tiles gives each tile's own result."""
    ai, bj = toy_mxu_tile.inputs(batch=3, device="cpu")["tile"]
    batched = toy_mxu_tile.tile(ai, bj)
    for b in range(3):
        torch.testing.assert_close(batched[b], toy_mxu_tile.tile(ai[b],
                                                                 bj[b]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("variant", toy_tea_roll.VARIANTS)
def test_t3_tea_roll_bitwise(variant):
    stack, iscal = toy_tea_roll.inputs("cpu")
    want = j_tea.run(variant, interpret=True)
    got = _np(toy_tea_roll.tea_roll(stack, iscal, variant))[0, 0]
    np.testing.assert_array_equal(got, want)


def test_t4_null_stage_bitwise(monkeypatch):
    monkeypatch.setattr(j_r5a, "SMOKE", True)
    view = r5a_stage.smoke_view("cpu")
    n_chan, ny2, zc, kp, l_lane = view.shape
    want = j_r5a.null_pallas(None, n_chan, ny2 - 2, zc, kp, l_lane)(
        jnp.asarray(_np(view)))
    np.testing.assert_array_equal(_np(r5a_stage.null_stage(view)),
                                  np.asarray(want))
    assert r5a_stage.bytes_moved(view) == 10 * (ny2 - 2) * zc * kp * \
        l_lane * 4


def test_probe_wrappers_without_nvcc_raise(monkeypatch):
    """On a non-CPU tensor with no kernel library and no compiler every
    probe wrapper raises; none falls back to its plain version."""
    import torch.utils.cpp_extension

    from meso_tpu_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("CUDA_PATH", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    _build.load_library.cache_clear()

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    calls = [
        lambda: toy_dynroll.dynroll(meta(8, 256), meta(1, 4,
                                                       dtype=torch.int32)),
        lambda: toy_dynroll.cond(meta(8, 256), meta(1, 2, dtype=torch.int32)),
        lambda: toy_mxu_tile.dot_a(meta(128, 8), meta(8, 128)),
        lambda: toy_mxu_tile.dot_b(meta(128, 128), meta(128, 8)),
        lambda: toy_mxu_tile.dot_c(meta(8, 128), meta(8, 128)),
        lambda: toy_mxu_tile.tile(meta(128, 8), meta(8, 128)),
        lambda: toy_tea_roll.tea_roll(meta(3, 1, 16, 60),
                                      meta(1, 2, dtype=torch.int32), "base"),
        lambda: r5a_stage.null_stage(meta(8, 5, 1, 8, 16))]
    before = dict(_build.LAUNCHES)
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert _build.LAUNCHES == before
