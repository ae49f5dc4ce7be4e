"""The port's multi-rank dry run (``parallel/dryrun.py``, the counterpart
of the JAX package's ``__graft_entry__.py::dryrun_multichip``) on 8 gloo
ranks on the CPU: the 3-D bricks over a 2 x 2 x 2 mesh on the sweep, the
1-D slabs through K4 on spill buckets, and the membrane suspension on the
first two ranks, each with its checks (overflow 0, N conserved, tags
unique, a finite state, bonded_missing 0), which raise where they fail."""

from meso_tpu_torch.parallel.dryrun import _factor3, dryrun_multichip
from test_torch_imports import one_torch_thread  # noqa: F401


def test_factor3_is_jax_s():
    assert [_factor3(n) for n in (1, 2, 4, 6, 8, 12, 27)] == [
        (1, 1, 1), (2, 1, 1), (2, 2, 1), (3, 2, 1), (2, 2, 2), (3, 2, 2),
        (3, 3, 3)]


def test_dryrun_multichip_8_ranks_on_the_cpu():
    report = dryrun_multichip(8, device="cpu")
    assert report["bricks_3d"]["ranks"] == 8
    assert report["slabs_k4"]["ranks"] == 8
    assert report["membrane"]["ranks"] == 2
    assert all(d["bonded_missing"] == 0
               for d in report["membrane"]["diags"])
