"""chip_smoke.py's checkers and phases, applied to CPU runs at small size
(the script itself refuses to run without a GPU)."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from gie_mapping_tpu.models.mapper import VolumetricMapper
from gie_mapping_tpu.runtime.datasets import BoxWorld, circular_trajectory
from gie_mapping_tpu.utils.config import cow_lady_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(local_size_m=(3.2, 3.2, 1.6), voxel_width=0.2)


@pytest.fixture(scope="module")
def mapped_state():
    cfg = cow_lady_config(**SMALL, max_raycast_points=4096,
                          display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=3, n_pillars=6, extent=3.0)
    m = VolumetricMapper(cfg)
    for i, p in enumerate(circular_trajectory(5, radius=0.8, height=0.6)):
        m.process_pointcloud(p, world.pointcloud(p, n_rays=4096,
                                                 max_range=4.0, seed=i))
    return cs.state_arrays(m.state)


def test_invariants_hold_on_a_mapped_state(mapped_state):
    inv = cs.invariant_violations(mapped_state["vox_type"],
                                  mapped_state["dist_sq"],
                                  mapped_state["coc"])
    assert inv["checked"] > 500
    assert inv["I1"] == inv["I2"] == inv["I3"] == 0


@pytest.mark.parametrize("broken", ["I1", "I2", "I3"])
def test_invariant_checker_catches_corruption(mapped_state, broken):
    s = {k: v.copy() for k, v in mapped_state.items()}
    valid = ((s["vox_type"] != cs.VOX_UNKNOWN)
             & (s["dist_sq"] != cs.EMPTY_VALUE)
             & (s["coc"][..., 0] != cs.COC_INVALID))
    v = tuple(np.argwhere(valid & (s["dist_sq"] > 0))[0])
    if broken == "I1":
        s["dist_sq"][v] += 1
    elif broken == "I2":
        c = tuple(s["coc"][v].astype(int))
        s["vox_type"][c] = 1            # the stored obstacle is gone
    else:
        # a closer obstacle the stored pair missed (the voxel next to v)
        nb = list(v)
        nb[2] = nb[2] + 1 if nb[2] + 1 < s["vox_type"].shape[2] else nb[2] - 1
        s["vox_type"][tuple(nb)] = cs.VOX_OCCUPIED
    inv = cs.invariant_violations(s["vox_type"], s["dist_sq"], s["coc"])
    assert inv[broken] > 0


def test_state_diff_and_mismatch_fraction(mapped_state):
    a = mapped_state
    b = {k: v.copy() for k, v in a.items()}
    assert cs.state_diff(a, b) == []
    b["dist_sq"].flat[0] ^= 1
    assert cs.state_diff(a, b) == ["dist_sq"]
    n, frac = cs.mismatch_fraction(a["vox_type"], a["vox_type"])
    assert n == 0 and frac == 0.0
    x = np.zeros(1000, np.int8)
    y = x.copy()
    y[:3] = 1
    assert cs.mismatch_fraction(x, y) == (3, 0.003)


def test_result_line_format():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = cs.result_line([Dev()])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')


def test_trajectory_holds_still_on_hold_frames():
    cfg = cow_lady_config(**SMALL)
    poses, steps = cs.trajectory(cfg, 8, hold=range(3, 5))
    assert steps == [0, 1, 2, 2, 2, 3, 4, 5]
    for a, b in ((2, 3), (3, 4)):
        np.testing.assert_array_equal(poses[a].trans, poses[b].trans)
        np.testing.assert_array_equal(poses[a].rot, poses[b].rot)
    assert not np.array_equal(poses[4].trans, poses[5].trans)
    assert cs.trajectory(cfg, 4)[1] == [0, 1, 2, 3]


@pytest.mark.parametrize("case", ["scan2D", "depthcam", "cow_lady"])
def test_preset_phase_on_cpu(case):
    """Phases 2-3 (per-frame, then replay; scrolls; bit-identical states;
    invariants for depthcam and cow_lady; cow_lady's default unfused
    per-frame path) at a small window on the CPU."""
    extra = {"max_raycast_points": 4096} if case == "cow_lady" else {}
    rec = cs.run_case(case, **SMALL, **extra)
    assert rec["replay_bit_identical"] and rec["scrolls"] >= 1
    assert rec["replay_scrolls"] >= 1 and rec["arch_dropped"] == 0
    if case in cs.INVARIANT_CASES:
        inv = rec["invariants"]
        assert inv["I1"] == inv["I2"] == inv["I3"] == 0
    if case in cs.UNFUSED_CASES:
        unf = rec["unfused"]
        assert unf["arch_dropped"] == 0 and unf["occupied"] == rec["occupied"]
        assert unf["bit_identical_to_fused"]
    else:
        assert "unfused" not in rec


def test_multi_phase_on_cpu():
    """--multi on 4 virtual CPU devices: the mesh run takes slab branches
    of the gated EDT and matches one device bit for bit."""
    rec = cs.multi_card(4, **SMALL, max_raycast_points=4096,
                        edt_gate_min_vox=0)
    assert rec["bit_identical"]
    assert any(0 <= g < rec["full_level"] for g in rec["gate_levels"])


def test_multi_phase_refuses_a_run_without_slab_branches():
    """With the gate off no slab branch runs, and the phase fails."""
    with pytest.raises(cs.PhaseError, match="no slab branch"):
        cs.multi_card(4, **SMALL, max_raycast_points=4096, edt_gate=False)


def test_card_vs_cpu_phase_on_cpu():
    rec = cs.card_vs_cpu("cow_lady", **SMALL, max_raycast_points=4096)
    assert rec["merge_bit_identical"] and rec["inst_mismatch"] == 0


def _run(cmd, cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_script_fails_without_a_gpu():
    r = _run([sys.executable, "chip_smoke.py"], ROOT,
             {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "phase 1" in r.stderr


def test_script_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run([sys.executable, "chip_smoke.py"], tmp_path,
             {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_preset_phases_on_the_card(gpu_device):
    """The smoke script's phases 2-4 at scan2D's preset canvas on the card
    (run with GIE_TEST_PLATFORMS=cuda,cpu; chip_smoke.py runs them all)."""
    rec = cs.run_case("scan2D")
    assert rec["replay_bit_identical"] and rec["scrolls"] >= 1
    rec = cs.card_vs_cpu("scan2D")
    assert rec["merge_bit_identical"]
    assert rec["inst_mismatch_frac"] <= cs.SENSOR_TOL
