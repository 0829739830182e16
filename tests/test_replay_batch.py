"""Batched replay (pipeline.replay_frames / process_pointcloud_batch) must be
bit-identical to the per-frame loop: same scroll decisions, same fusion, same
EDT, same archive state — the scan only changes HOW the frames are dispatched.

Covers both in-scan scroll paths: the full-canvas path (small canvases) and
the compacted-rows path of map_state._do_scroll (large canvases)."""
import dataclasses

import numpy as np
import pytest

from gie_mapping_tpu.models.mapper import VolumetricMapper
from gie_mapping_tpu.runtime.datasets import BoxWorld
from gie_mapping_tpu.utils import geometry as geo
from gie_mapping_tpu.utils.config import cow_lady_config


def _linear_poses(n, step=0.5, start=-1.8):
    eye = np.eye(3, dtype=np.float32)
    return [geo.Projection(rot=eye,
                           trans=np.asarray([start + step * i, 0.15 * i, 0.9],
                                            np.float32))
            for i in range(n)]


def _there_and_back(n, step=0.6, start=-1.5):
    """Out and back: blocks archived on the way out are re-fetched from the
    archive on the way back (exercises in-scan archive gets)."""
    eye = np.eye(3, dtype=np.float32)
    half = n // 2
    xs = [start + step * min(i, half) - step * max(0, i - half)
          for i in range(n)]
    return [geo.Projection(rot=eye, trans=np.asarray([x, 0.0, 0.9], np.float32))
            for x in xs]


def _run_pair(cfg, n_frames, chunk):
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    poses = _linear_poses(n_frames)
    clouds = [world.pointcloud(p, n_rays=cfg.max_raycast_points, max_range=6.0,
                               seed=i) for i, p in enumerate(poses)]

    m_ref = VolumetricMapper(cfg)
    pts_r, val_r = m_ref.stage_pointcloud_batch(clouds)
    for i, p in enumerate(poses):
        out_ref = m_ref.process_pointcloud(p, pts_r[i], val_r[i])

    m_bat = VolumetricMapper(cfg)
    pts_b, val_b = m_bat.stage_pointcloud_batch(clouds)
    out_bat = m_bat.process_pointcloud_batch(poses, pts_b, val_b, chunk=chunk)
    return m_ref, out_ref, m_bat, out_bat


def _assert_equal(m_ref, out_ref, m_bat, out_bat):
    for f in dataclasses.fields(m_ref.state):
        a = np.asarray(getattr(m_ref.state, f.name))
        b = np.asarray(getattr(m_bat.state, f.name))
        np.testing.assert_array_equal(a, b, err_msg=f"state.{f.name}")
    for k in ("edt", "dist_sq", "coc", "glb_type"):
        np.testing.assert_array_equal(
            np.asarray(out_ref.device(k)), np.asarray(out_bat.device(k)),
            err_msg=f"output {k}")
    assert m_ref.map_ct == m_bat.map_ct
    assert np.array_equal(m_ref._origin, m_bat._origin)


def test_replay_batch_small_canvas_full_scroll():
    """nb < 256: in-scan scrolls take the full-canvas traced path."""
    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(4.0, 4.0, 1.6), cutoff_dist=1.0,
        max_blocks=1024, max_raycast_points=256, fuse_raycast=True,
        display_glb_edt=False, display_glb_ogm=False)
    assert int(np.prod(cfg.canvas_blocks)) < VolumetricMapper.REPLAY_ROWS
    _assert_equal(*_run_pair(cfg, n_frames=8, chunk=3))


def test_replay_batch_compacted_scroll():
    """nb >= 256: in-scan scrolls use the compacted-archive bounds."""
    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(9.6, 9.6, 1.6), cutoff_dist=1.0,
        max_blocks=2048, max_raycast_points=256, fuse_raycast=True,
        display_glb_edt=False, display_glb_ogm=False)
    cb = np.asarray(cfg.canvas_blocks)
    assert int(cb.prod()) >= VolumetricMapper.REPLAY_ROWS
    m_ref, out_ref, m_bat, out_bat = _run_pair(cfg, n_frames=8, chunk=3)
    _assert_equal(m_ref, out_ref, m_bat, out_bat)
    # the trajectory must actually scroll inside a scanned chunk for this
    # test to mean anything
    assert m_bat.replay_scanned_frames >= 3
    assert m_bat.replay_scanned_scrolls >= 1


def test_replay_batch_scroll_free_run():
    """A batch whose plan contains ZERO scrolls dispatches the no-cond scan
    body (has_scrolls=False — the scroll cond's identity branch copies every
    carried canvas buffer per frame, so scroll-free runs skip it entirely)
    and must stay bit-identical to the per-frame loop."""
    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(4.0, 4.0, 1.6), cutoff_dist=1.0,
        max_blocks=1024, max_raycast_points=256, fuse_raycast=True,
        display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    eye = np.eye(3, dtype=np.float32)
    # tiny jitter around a fixed spot: the canvas origin never moves
    poses = [geo.Projection(rot=eye,
                            trans=np.asarray([0.03 * (i % 3), 0.02 * (i % 2),
                                              0.9], np.float32))
             for i in range(8)]
    clouds = [world.pointcloud(p, n_rays=cfg.max_raycast_points, max_range=6.0,
                               seed=i) for i, p in enumerate(poses)]

    m_ref = VolumetricMapper(cfg)
    pts_r, val_r = m_ref.stage_pointcloud_batch(clouds)
    for i, p in enumerate(poses):
        out_ref = m_ref.process_pointcloud(p, pts_r[i], val_r[i])

    m_bat = VolumetricMapper(cfg)
    pts_b, val_b = m_bat.stage_pointcloud_batch(clouds)
    # one per-frame call to establish the origin (a fresh map's first frame
    # always takes the per-frame path), then a scroll-free scanned batch
    m_bat.process_pointcloud(poses[0], pts_b[0], val_b[0])
    out_bat = m_bat.process_pointcloud_batch(poses[1:], pts_b[1:], val_b[1:],
                                             chunk=7)
    assert m_bat.replay_scanned_frames >= 7
    assert m_bat.replay_scanned_scrolls == 0
    _assert_equal(m_ref, out_ref, m_bat, out_bat)


def test_replay_batch_archive_roundtrip():
    """Out-and-back trajectory: blocks archived by in-scan scrolls must be
    re-fetched from the archive by later in-scan scrolls, matching the
    per-frame loop bitwise."""
    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(9.6, 9.6, 1.6), cutoff_dist=1.0,
        max_blocks=2048, max_raycast_points=256, fuse_raycast=True,
        display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=9, n_pillars=5, extent=3.0, height=2.0)
    poses = _there_and_back(14, step=1.1)
    clouds = [world.pointcloud(p, n_rays=256, max_range=6.0, seed=i)
              for i, p in enumerate(poses)]

    m_ref = VolumetricMapper(cfg)
    pts, val = m_ref.stage_pointcloud_batch(clouds)
    for i, p in enumerate(poses):
        out_ref = m_ref.process_pointcloud(p, pts[i], val[i])
    assert int(np.asarray(m_ref.state.n_arch)) > 0  # something archived

    m_bat = VolumetricMapper(cfg)
    pts_b, val_b = m_bat.stage_pointcloud_batch(clouds)
    out_bat = m_bat.process_pointcloud_batch(poses, pts_b, val_b, chunk=4)
    _assert_equal(m_ref, out_ref, m_bat, out_bat)
    assert m_bat.replay_scanned_scrolls >= 2  # archive put AND get in-scan


def test_replay_batch_scan2d_sensor_kind():
    """The in-scan fused projection-sensor path (sensor_kind='scan') must be
    bit-identical to the per-frame loop."""
    from gie_mapping_tpu.utils.config import scan2d_config

    cfg = scan2d_config(local_size_m=(4.8, 4.8, 1.2), voxel_width=0.2,
                        cutoff_dist=1.0, max_blocks=1024)
    world = BoxWorld.corridor(seed=5, n_pillars=4, extent=3.0)
    poses = _linear_poses(7, step=0.45)
    scans = [world.scan_2d(p, n_beams=120) for p in poses]

    m_ref = VolumetricMapper(cfg)
    for p, (rng_, tmin, tinc) in zip(poses, scans):
        out_ref = m_ref.process_scan2d(p, rng_, tmin, tinc)

    m_bat = VolumetricMapper(cfg)
    ranges = np.stack([s[0] for s in scans])
    out_bat = m_bat.process_scan2d_batch(poses, ranges, scans[0][1],
                                         scans[0][2], chunk=3)
    _assert_equal(m_ref, out_ref, m_bat, out_bat)


def test_replay_batch_depth_sensor_kind():
    """Same for the depth-camera pipeline (sensor_kind='depth')."""
    from gie_mapping_tpu.utils.config import depthcam_config

    cfg = depthcam_config(local_size_m=(4.0, 4.0, 1.6), voxel_width=0.2,
                          cutoff_dist=1.0, max_blocks=1024)
    world = BoxWorld.corridor(seed=7, n_pillars=4, extent=3.0, height=2.0)
    poses = _linear_poses(7, step=0.45)
    fx = fy = 20.0
    cx, cy = 16.0, 12.0
    depths = [world.depth_image(p, 24, 32, fx, fy, cx, cy)[0]
              for p in poses]

    m_ref = VolumetricMapper(cfg)
    for p, d in zip(poses, depths):
        out_ref = m_ref.process_depth(p, d, fx, fy, cx, cy)

    m_bat = VolumetricMapper(cfg)
    out_bat = m_bat.process_depth_batch(poses, np.stack(depths), fx, fy,
                                        cx, cy, chunk=3)
    _assert_equal(m_ref, out_ref, m_bat, out_bat)


def test_replay_batch_fence_activation_flip():
    """A fence box whose window-overlap activation flips mid-trajectory: the
    chunk planner must split there and stay bit-identical to the per-frame
    loop (which re-evaluates activation every frame)."""
    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(4.0, 4.0, 1.6), cutoff_dist=1.0,
        max_blocks=1024, max_raycast_points=256, fuse_raycast=True,
        display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    poses = _linear_poses(8)
    clouds = [world.pointcloud(p, n_rays=256, max_range=6.0, seed=i)
              for i, p in enumerate(poses)]
    # a fence box that only the later windows overlap
    box_ll = np.asarray([3.0, -0.5, 0.0], np.float32)
    box_ur = np.asarray([3.6, 0.8, 1.4], np.float32)

    m_ref = VolumetricMapper(cfg)
    m_ref.ext_obs.append(box_ll, box_ur)
    pts, val = m_ref.stage_pointcloud_batch(clouds)
    for i, p in enumerate(poses):
        out_ref = m_ref.process_pointcloud(p, pts[i], val[i])

    m_bat = VolumetricMapper(cfg)
    m_bat.ext_obs.append(box_ll, box_ur)
    pts_b, val_b = m_bat.stage_pointcloud_batch(clouds)
    out_bat = m_bat.process_pointcloud_batch(poses, pts_b, val_b, chunk=3)
    _assert_equal(m_ref, out_ref, m_bat, out_bat)
    # the box must actually have been active at some point for this test to
    # mean anything
    assert any(m_ref.ext_obs.activate(
        p.trans * 1.0 - 2.0, p.trans * 1.0 + 2.0).any() for p in poses)


def test_replay_batch_streaming_mirror():
    """Changed-block streaming at chunk cadence (union of changed blocks)
    must leave the host mirror with the same content as the per-frame loop
    once the world is static (every changed block streamed with final
    state)."""
    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(4.0, 4.0, 1.6), cutoff_dist=1.0,
        max_blocks=1024, max_raycast_points=256, fuse_raycast=True,
        display_glb_ogm=True, display_glb_edt=True, vis_interval=1)
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    pose = geo.Projection(rot=np.eye(3, dtype=np.float32),
                          trans=np.asarray([0.0, 0.0, 0.9], np.float32))
    cloud = world.pointcloud(pose, n_rays=256, max_range=6.0, seed=1)
    K = 6  # static world: occupancy/EDT settle after a couple of frames

    m_ref = VolumetricMapper(cfg)
    pts, val = m_ref.stage_pointcloud_batch([cloud] * K)
    for i in range(K):
        m_ref.process_pointcloud(pose, pts[i], val[i])
    m_ref.flush_stream()

    m_bat = VolumetricMapper(cfg)
    pts_b, val_b = m_bat.stage_pointcloud_batch([cloud] * K)
    m_bat.process_pointcloud_batch([pose] * K, pts_b, val_b, chunk=5)
    m_bat.flush_stream()

    assert m_ref.mirror is not None and m_bat.mirror is not None
    assert set(m_ref.mirror.blocks) == set(m_bat.mirror.blocks)
    assert len(m_ref.mirror) > 0
    for key, blk in m_ref.mirror.blocks.items():
        for f in ("occ_val", "vox_type", "dist_sq", "coc"):
            np.testing.assert_array_equal(
                blk[f], m_bat.mirror.blocks[key][f],
                err_msg=f"mirror[{key}][{f}]")


def test_replay_batch_teleport_falls_back():
    """A teleport mid-batch exceeds the compact bounds: the planner must
    split around it and still match the per-frame loop."""
    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(9.6, 9.6, 1.6), cutoff_dist=1.0,
        max_blocks=2048, max_raycast_points=256, fuse_raycast=True,
        display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    poses = _linear_poses(7)
    # teleport at frame 4
    poses[4] = geo.Projection(rot=np.eye(3, dtype=np.float32),
                              trans=np.asarray([14.0, 9.0, 0.9], np.float32))
    clouds = [world.pointcloud(p, n_rays=256, max_range=6.0, seed=i)
              for i, p in enumerate(poses)]

    m_ref = VolumetricMapper(cfg)
    pts, val = m_ref.stage_pointcloud_batch(clouds)
    for i, p in enumerate(poses):
        out_ref = m_ref.process_pointcloud(p, pts[i], val[i])
    m_bat = VolumetricMapper(cfg)
    pts_b, val_b = m_bat.stage_pointcloud_batch(clouds)
    out_bat = m_bat.process_pointcloud_batch(poses, pts_b, val_b, chunk=3)
    _assert_equal(m_ref, out_ref, m_bat, out_bat)


def test_replay_batch_fence_churn_and_ext_cloud():
    """Fence-box CHURN across a there-and-back trajectory (VERDICT r2 weak
    6): multiple boxes whose activation toggles several times (multiple
    chunk splits), plus a process_ext_cloud re-clustering between batches
    (the reference's CB_ext_cld resets and re-appends boxes per message,
    volumetric_mapper.cpp:391-496) — bit-identical to the per-frame loop
    doing the same at the same frame index."""
    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(4.0, 4.0, 1.6), cutoff_dist=1.0,
        max_blocks=2048, max_raycast_points=256, fuse_raycast=True,
        display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=3, n_pillars=5, extent=3.0, height=2.0)
    poses = _there_and_back(14, step=0.8, start=-2.0)
    clouds = [world.pointcloud(p, n_rays=256, max_range=6.0, seed=i)
              for i, p in enumerate(poses)]
    boxes = [(np.asarray([2.4, -0.5, 0.0], np.float32),
              np.asarray([3.0, 0.8, 1.4], np.float32)),
             (np.asarray([-4.6, -0.4, 0.0], np.float32),
              np.asarray([-4.0, 0.6, 1.2], np.float32))]
    # an external-observer cluster (>=4 pts within eps) near the path
    rng = np.random.default_rng(9)
    ext_cloud = (np.asarray([1.0, 0.6, 0.5], np.float32)
                 + rng.uniform(-0.05, 0.05, (8, 3)).astype(np.float32))

    def drive(batch):
        m = VolumetricMapper(cfg)
        for ll, ur in boxes:
            m.ext_obs.append(ll, ur)
        pts, val = m.stage_pointcloud_batch(clouds)
        out = None
        if batch:
            out = m.process_pointcloud_batch(poses[:7], pts[:7], val[:7],
                                             chunk=3)
            m.process_ext_cloud(ext_cloud)
            out = m.process_pointcloud_batch(poses[7:], pts[7:], val[7:],
                                             chunk=3)
        else:
            for i, p in enumerate(poses):
                if i == 7:
                    m.process_ext_cloud(ext_cloud)
                out = m.process_pointcloud(p, pts[i], val[i])
        return m, out

    m_ref, out_ref = drive(batch=False)
    m_bat, out_bat = drive(batch=True)
    _assert_equal(m_ref, out_ref, m_bat, out_bat)

    # churn really happened: activation signatures change >= 3 times along
    # the trajectory (multiple chunk splits), and the ext cloud added a box
    sigs = []
    for p in poses:
        ll = p.trans.astype(np.float32) * 0 + (
            geo.calculate_pivot(np.asarray(p.trans), cfg.voxel_width,
                                cfg.local_size).astype(np.float32)
            * cfg.voxel_width)
        sigs.append(m_ref.ext_obs.activate(
            ll, ll + np.asarray(cfg.local_size_m, np.float32)).tobytes())
    assert len({s for s in sigs}) >= 2
    assert sum(a != b for a, b in zip(sigs, sigs[1:])) >= 3
    assert m_ref.ext_obs.n >= 2  # ext cloud appended at least one cluster box


def test_staging_bucket_matches_full_capacity():
    """Live-point bucketed staging (round 4: the panorama scatters cost per
    PADDED index) must be output- and state-identical to staging at the full
    cfg.max_raycast_points capacity — padded points are masked everywhere."""
    from gie_mapping_tpu.utils.config import cow_lady_config

    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(4.0, 4.0, 1.6), cutoff_dist=1.0,
        max_blocks=1024, max_raycast_points=16384, fuse_raycast=True,
        display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=5, n_pillars=4, extent=2.5, height=1.5)
    poses = _linear_poses(6, step=0.4)
    clouds = [world.pointcloud(p, n_rays=3000, max_range=5.0, seed=i)
              for i, p in enumerate(poses)]

    m_a = VolumetricMapper(cfg)
    pts_a, val_a = m_a.stage_pointcloud_batch(clouds)          # bucket: 4096
    assert pts_a.shape[1] == 4096
    out_a = m_a.process_pointcloud_batch(poses, pts_a, val_a, chunk=3)

    m_b = VolumetricMapper(cfg)
    pts_b, val_b = m_b.stage_pointcloud_batch(clouds, pad_to=16384)
    assert pts_b.shape[1] == 16384
    out_b = m_b.process_pointcloud_batch(poses, pts_b, val_b, chunk=3)

    _assert_equal(m_a, out_a, m_b, out_b)


def test_replay_batch_relax_engine():
    """The outputs-light scan must keep the relax engine's coc write-back
    intact (its state path reads the window coc crop, unlike canvas_edt's
    take-splice — caught as a latent None in round 4)."""
    from gie_mapping_tpu.utils.config import cow_lady_config

    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(4.0, 4.0, 1.6), cutoff_dist=1.0,
        max_blocks=1024, max_raycast_points=2048, fuse_raycast=True,
        merge_mode="relax",
        display_glb_edt=False, display_glb_ogm=False)
    _assert_equal(*_run_pair(cfg, n_frames=6, chunk=3))


def test_replay_batch_short_ladder_rungs():
    """Post-teleport tails dispatch through the round-5 short ladder rungs
    (5, 2) instead of per-frame fallbacks; bit-identity must hold across
    the mixed run lengths.  12 frames with a teleport at frame 4: the plan
    splits into [fresh-fallback, 2-run, 1-fallback, teleport-fallback,
    return-teleport-fallback, 5-run, 1-fallback] at chunk=8 (ladder
    [8, 5, 4, 2]) — the 7 scanned frames can only be the 2- and 5-rungs."""
    cfg = cow_lady_config(
        voxel_width=0.2, local_size_m=(9.6, 9.6, 1.6), cutoff_dist=1.0,
        max_blocks=2048, max_raycast_points=256, fuse_raycast=True,
        display_glb_edt=False, display_glb_ogm=False)
    world = BoxWorld.corridor(seed=7, n_pillars=5, extent=3.0, height=2.0)
    poses = _linear_poses(12)
    poses[4] = geo.Projection(rot=np.eye(3, dtype=np.float32),
                              trans=np.asarray([15.0, 8.0, 0.9], np.float32))
    clouds = [world.pointcloud(p, n_rays=256, max_range=6.0, seed=i)
              for i, p in enumerate(poses)]

    m_ref = VolumetricMapper(cfg)
    pts, val = m_ref.stage_pointcloud_batch(clouds)
    for i, p in enumerate(poses):
        out_ref = m_ref.process_pointcloud(p, pts[i], val[i])
    m_bat = VolumetricMapper(cfg)
    pts_b, val_b = m_bat.stage_pointcloud_batch(clouds)
    out_bat = m_bat.process_pointcloud_batch(poses, pts_b, val_b, chunk=8)
    _assert_equal(m_ref, out_ref, m_bat, out_bat)
    # runs of 2 and 5 scanned (both short rungs engaged); the fresh frame,
    # the frame before the jump, both teleports and the single tail frame
    # dispatch per-frame
    assert m_bat.replay_scanned_frames == 7
