"""The JAX package's unit tests: which of them are ``slow``, and the
``MESO_PALLAS_INTERPRET`` variable put back after each test.

``slow`` means more than 60 s alone on the CPU. Each test named below traces
and compiles its own configuration of the interpreted v3 kernel
(``meso_tpu/kernels/pair_dpd_v3.py`` with ``interpret=True``): minutes
alone, one to ten GB of memory. The dyn_roll kernels build a far smaller
graph and stay out of this list. Run the set with ``-m slow``.
"""

import os

import pytest

_UNIT_DIR = os.path.dirname(os.path.abspath(__file__))

# file -> names (``item.name`` or, for every case of a parametrised test,
# ``item.originalname``); None marks every test of the file
SLOW = {
    "test_pallas_v3.py": {
        "test_v3_matches_dense",
        "test_v3_multitype",
        "test_v3_multitype_spill",
        "test_v3_s_exp",
        "test_v3_z_chunks",
        "test_v3_z_chunks_spill",
        "test_v3_special_bonds",
        "test_v3_odd_capacity",
        "test_v3_wide_box_nx8",
        "test_v3_matches_v2_bitpath",
    },
    "test_pallas_v3_transport.py": None,
    "test_wrap_mode.py": {
        "test_v3_no_min_image_parity[True-fast-0-None-False]",
        "test_v3_no_min_image_parity[False-fast-0-None-False]",
        "test_v3_no_min_image_parity[True-tea-0-None-False]",
        "test_v3_no_min_image_parity[True-fast-2-None-False]",
        "test_v3_no_min_image_parity[False-fast-0-20-False]",
        "test_wrap_relief_preshift_under_deferred_wrap",
        "test_wrap_mode_rebuild_full_loop_physics",
    },
    "test_pallas_fused.py": {"test_spill_production_loop_matches_bucket"},
    "test_v3_nv.py": {"test_need_virial_false_is_force_bitwise"},
    "test_utils.py": {"test_autotune_sweeps_dynroll_winner"},
}


@pytest.hookimpl(tryfirst=True)   # before ``-m`` deselects by marker
def pytest_collection_modifyitems(items):
    for item in items:
        if os.path.dirname(str(item.path)) != _UNIT_DIR:
            continue
        names = SLOW.get(item.path.name, ())
        if names is None or item.name in names or getattr(
                item, "originalname", None) in names:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _restore_pallas_interpret():
    """Some tests assign ``MESO_PALLAS_INTERPRET`` (read when the production
    paths trace): put back what it was before, so that no test's kernel path
    depends on what ran before it in its worker."""
    before = os.environ.get("MESO_PALLAS_INTERPRET")
    yield
    if before is None:
        os.environ.pop("MESO_PALLAS_INTERPRET", None)
    else:
        os.environ["MESO_PALLAS_INTERPRET"] = before
