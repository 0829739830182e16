"""Config parity: all five benchmark presets + parsing the reference's own
yaml files."""
import glob
import os

import pytest

from gie_mapping_tpu.utils.config import (
    PRESETS,
    load_config,
    load_config_yaml,
    cow_lady_config,
    scan2d_config,
    ugv_corridor_config,
)


def test_presets_cover_benchmark_cases():
    for name in ("scan2D", "cow_lady", "ugv_corridor", "depthcam", "laser3D",
                 "uav_raycast_fine"):
        cfg = load_config(name)
        assert cfg.map_volume > 0
        assert cfg.canvas_size >= cfg.local_size


def test_cow_lady_numbers():
    cfg = cow_lady_config()
    assert cfg.local_size == (100, 100, 30)
    assert cfg.voxel_width == 0.1
    assert not cfg.fast_mode
    assert cfg.cutoff_grids_sq == 400  # (2m / 0.1m)^2
    assert cfg.max_blocks == 11997


def test_scan2d_numbers():
    cfg = scan2d_config()
    assert cfg.for_motion_planner
    assert cfg.fast_mode
    assert cfg.robot_r2_grids == 4  # ceil(0.2/0.1)^2


def test_ugv_capacity():
    cfg = ugv_corridor_config()
    assert cfg.local_size == (200, 200, 24)
    assert cfg.max_blocks == 21997


@pytest.mark.skipif(not os.path.isdir("/root/reference/cfg"),
                    reason="reference tree not mounted")
def test_parse_reference_yamls():
    files = sorted(glob.glob("/root/reference/cfg/*.yaml"))
    assert len(files) >= 6
    for f in files:
        cfg = load_config_yaml(f)
        assert cfg.map_volume > 0
        assert 0 < cfg.voxel_width <= 0.5

    cow = load_config_yaml("/root/reference/cfg/cow_lady_params.yaml")
    assert cow.local_size == (100, 100, 30)
    assert not cow.fast_mode
    assert cow.max_blocks == 11997


def test_invalid_enum_values_rejected():
    import pytest as _pytest

    from gie_mapping_tpu.utils.config import MapConfig

    with _pytest.raises(ValueError, match="merge_mode"):
        MapConfig(merge_mode="bogus")
    with _pytest.raises(ValueError, match="edt_gate_pmode"):
        MapConfig(edt_gate_pmode="bogus")
