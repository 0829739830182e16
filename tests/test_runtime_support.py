"""Support code around the engine: the full-precision pose transform, the
compile-cache placement, the device record and the trace reduction."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gie_mapping_tpu.runtime import compile_cache, devinfo, trace_metrics
from gie_mapping_tpu.utils import geometry as geo


# ---- full-precision transforms ------------------------------------------

def _pose(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    return (geo.quat_to_rot(*q).astype(np.float32),
            rng.uniform(-50, 50, 3).astype(np.float32))


@pytest.mark.parametrize("jit", [False, True])
def test_rigid_transform_matches_float64(jit):
    rot, trans = _pose(1)
    pts = np.random.default_rng(2).uniform(-8, 8, (4096, 3)).astype(np.float32)
    fn = jax.jit(geo.rigid_transform) if jit else geo.rigid_transform
    got = np.asarray(fn(jnp.asarray(pts), jnp.asarray(rot), jnp.asarray(trans)))
    want = pts.astype(np.float64) @ rot.T.astype(np.float64) + trans
    # float32 rounding only: far below a millimetre at these ranges
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_projection_round_trip_and_precision():
    rot, trans = _pose(3)
    proj = geo.Projection(jnp.asarray(rot), jnp.asarray(trans))
    pts = np.random.default_rng(4).uniform(-8, 8, (2048, 3)).astype(np.float32)
    world = np.asarray(proj.l2g(jnp.asarray(pts)))
    back = np.asarray(proj.g2l(jnp.asarray(world)))
    np.testing.assert_allclose(back, pts, rtol=0, atol=3e-5)
    want = (world.astype(np.float64) - trans) @ rot.astype(np.float64)
    np.testing.assert_allclose(back, want, rtol=0, atol=2e-5)


def test_transforms_ask_for_highest_precision():
    rot, trans = _pose(5)
    text = jax.jit(geo.rigid_transform).lower(
        jnp.zeros((8, 3)), jnp.asarray(rot), jnp.asarray(trans)).as_text()
    assert "HIGHEST" in text


# ---- compile cache -------------------------------------------------------

def test_compile_cache_honours_the_environment(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable() == "/some/where"
    assert calls == []  # nothing set in code


def test_compile_cache_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    d = compile_cache.enable()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", d)]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ---- device record -------------------------------------------------------

def test_device_record_names_the_platform():
    rec = devinfo.device_record()
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    assert isinstance(rec["device_kind"], str)


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        devinfo.require_gpu()


# ---- trace reduction -----------------------------------------------------

HLO = """HloModule jit_step, entry_computation_layout={()->f32[]}

%fused_computation.1 (p: f32[8]) -> f32[8] {
  %p = f32[8]{0} parameter(0)
  ROOT %m = f32[8]{0} multiply(%p, %p), metadata={op_name="jit(step)/scroll/mul"}
}

%body.4 (p.1: (f32[8], /*index=1*/f32[8])) -> (f32[8], /*index=1*/f32[8]) {
  %p.1 = (f32[8]{0}, /*index=1*/f32[8]{0}) parameter(0)
  ROOT %fusion.5 = (f32[8]{0}, /*index=1*/f32[8]{0}) fusion(%p.1), kind=kLoop, calls=%fused_computation.1
}

ENTRY %main (a: f32[8]) -> f32[8] {
  %a = f32[8]{0} parameter(0)
  %fusion.1 = f32[8]{0} fusion(%a), kind=kLoop, calls=%fused_computation.1
  %cc.2 = f32[8]{0} custom-call(%fusion.1), custom_call_target="my_kernel", metadata={op_name="jit(step)/edt_envelope/pallas_call"}
  ROOT %add.3 = f32[8]{0} add(%cc.2, %a), metadata={op_name="jit(step)/add"}
}
"""


def test_parse_hlo_text_attributes_fusions_to_stages():
    module, stages = trace_metrics.parse_hlo_text(HLO)
    assert module == "jit_step"
    assert stages["fusion.1"] == "scroll"      # from the fused op
    assert stages["cc.2"] == "edt_envelope"    # own op_name
    assert stages["add.3"] is None
    # computations whose tuple parameters carry /*index=N*/ comments
    assert stages["fusion.5"] == "scroll"


def test_union_of_intervals():
    assert trace_metrics._union_ns([(0, 10), (5, 12), (20, 25)]) == 17
    assert trace_metrics._union_ns([]) == 0


def test_stage_metrics_on_a_recorded_trace(tmp_path):
    dump = tmp_path / "dump"
    trace = tmp_path / "trace"

    @jax.jit
    def step(x):
        with jax.named_scope("scroll"):
            y = jnp.roll(x, 3, axis=1) * 2.0
        return jnp.sin(y) + 1.0

    x = jnp.ones((256, 256))
    step(x).block_until_ready()
    with jax.profiler.trace(str(trace)):
        for _ in range(3):
            step(x).block_until_ready()
    xp = glob.glob(str(trace / "plugins" / "profile" / "*" / "*.xplane.pb"))
    assert xp
    evs = trace_metrics.device_events(xp[0])
    pid = next(e[3] for e in evs if e[3] >= 0)
    hlo = step.lower(x).compile().as_text()
    dump.mkdir()
    (dump / f"module_{pid:04d}.jit_step.cpu_after_optimizations.txt"
     ).write_text(hlo)
    m = trace_metrics.stage_metrics(xp[0], trace_metrics.hlo_stage_map(
        str(dump)))
    assert m["n_events"] > 0 and 0 < m["busy_ns"] <= m["window_ns"]
    assert 0.0 <= m["idle_share"] < 1.0
    assert sum(m["stage_ns"].values()) == m["kernel_ns"]
    assert m["stage_ns"]["scroll"] > 0
