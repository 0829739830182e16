"""Projection ("inverse") sensor models: 2-D LiDAR, depth camera, multi-ring
3-D LiDAR.

Dense redesign of the reference's per-column SIMT kernels
(/root/reference/src/kernel/hokuyo/hokuyo_fast.cu:9-91,
 src/kernel/realsense/realsense_fast.cu:9-104,
 src/kernel/vlp16/vlp16_fast.cu:8-97): the grid=(z), block=(y), serial-x loop
structure becomes one dense vectorised map over the whole local window — every
voxel is projected into the measurement array and compared against the
measured ray, with one gather from the (small) measurement buffer.

Each model returns ``inst_type`` int8 [X,Y,Z] (VOX_UNKNOWN / VOX_FREE /
VOX_OCCUPIED).  A voxel is "observed" iff inst_type != UNKNOWN — this is the
dense-mask equivalent of the reference's per-voxel VB-key output
(hokuyo_fast.cu:38,48,65-78), which downstream block allocation consumes.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..utils import geometry as geo
from ..utils.constants import VOX_FREE, VOX_OCCUPIED, VOX_UNKNOWN, SENS_FAR_DIST


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ScanParam:
    """2-D scan geometry (reference ScanParam, cuda_toolkit/occupancy/hokuyo/scan_param.h)."""

    theta_min: jnp.ndarray
    theta_inc: jnp.ndarray
    ranges: jnp.ndarray  # [scan_num] float32 measured depths

    @property
    def scan_num(self):
        return self.ranges.shape[0]

    def tree_flatten(self):
        return (self.theta_min, self.theta_inc, self.ranges), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class CamParam:
    """Pinhole intrinsics + depth image (reference CamParam, camera_param.h)."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    depth: jnp.ndarray  # [rows, cols] float32

    def tree_flatten(self):
        return (self.fx, self.fy, self.cx, self.cy, self.depth), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MulScanParam:
    """Multi-ring spinning-LiDAR geometry (reference MulScanParam, multiscan_param.h)."""

    theta_min: jnp.ndarray
    theta_inc: jnp.ndarray
    phi_min: jnp.ndarray
    phi_inc: jnp.ndarray
    rings: jnp.ndarray  # [ring_num, scan_num] float32 range image

    @property
    def ring_num(self):
        return self.rings.shape[0]

    @property
    def scan_num(self):
        return self.rings.shape[1]

    def tree_flatten(self):
        return (self.theta_min, self.theta_inc, self.phi_min, self.phi_inc, self.rings), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _window_positions(pvt, local_size, voxel_width):
    """(X,Y,Z,3) float32 world positions of every window voxel centre."""
    loc = geo.local_coord_grid(local_size)
    return geo.coord2pos(loc + pvt[None, None, None, :], voxel_width), loc


def _robot_sphere_mask(local_size, robot_r2_grids):
    """Voxels within the robot radius of the window centre (hokuyo_fast.cu:32-41)."""
    loc = geo.local_coord_grid(local_size)
    half = jnp.asarray([s // 2 for s in local_size], jnp.int32)
    d = loc - half
    return jnp.sum(d * d, axis=-1) <= robot_r2_grids


def _positive_mod(i, n):
    return jnp.mod(jnp.mod(i, n) + n, n)


@partial(jax.jit, static_argnames=(
    "local_size", "voxel_width", "ogm_min_h", "ogm_max_h",
    "for_motion_planner", "robot_r2_grids"))
def hokuyo_update(proj, param: ScanParam, pvt, *, local_size, voxel_width,
                  ogm_min_h, ogm_max_h, for_motion_planner: bool, robot_r2_grids: int):
    """2-D LiDAR inverse model (hokuyo_fast.cu:9-91, hokuyo_helper.h:16-33)."""
    glb_pos, _ = _window_positions(pvt, local_size, voxel_width)
    local_pos = proj.g2l(glb_pos)

    theta = jnp.arctan2(local_pos[..., 1], local_pos[..., 0])
    theta_idx = jnp.floor((theta - param.theta_min) / param.theta_inc + 0.5).astype(jnp.int32)
    theta_idx = _positive_mod(theta_idx, param.scan_num)
    planar = jnp.abs(local_pos[..., 2]) < voxel_width
    idea_depth = jnp.where(
        planar, jnp.sqrt(local_pos[..., 0] ** 2 + local_pos[..., 1] ** 2), -1.0
    )

    real_depth = param.ranges[jnp.clip(theta_idx, 0, param.scan_num - 1)]
    meas_ok = (idea_depth >= 0) & ~jnp.isnan(real_depth) & (real_depth > 0.3)

    free = meas_ok & (idea_depth < real_depth - 0.3)
    hgt_ok = (glb_pos[..., 2] >= ogm_min_h) & (glb_pos[..., 2] <= ogm_max_h)
    occ = meas_ok & (idea_depth >= real_depth - 0.3) & (idea_depth <= real_depth + 0.3) & hgt_ok

    inst = jnp.where(occ, VOX_OCCUPIED, jnp.where(free, VOX_FREE, VOX_UNKNOWN))
    if for_motion_planner:
        inst = jnp.where(_robot_sphere_mask(local_size, robot_r2_grids), VOX_FREE, inst)
    return inst.astype(jnp.int8)


@partial(jax.jit, static_argnames=(
    "local_size", "voxel_width", "ogm_min_h", "ogm_max_h",
    "for_motion_planner", "robot_r2_grids", "valid_nan"))
def realsense_update(proj, param: CamParam, pvt, *, local_size, voxel_width,
                     ogm_min_h, ogm_max_h, for_motion_planner: bool,
                     robot_r2_grids: int, valid_nan: bool = False):
    """Depth-camera inverse model (realsense_fast.cu:9-104, camera_helper.h:10-23).

    Sensor frame convention follows the reference: x forward (depth), y left,
    z up; pixel = (-y*fx/depth + cx, -z*fy/depth + cy).
    """
    rows, cols = param.depth.shape
    glb_pos, _ = _window_positions(pvt, local_size, voxel_width)
    local_pos = proj.g2l(glb_pos)

    idea_depth = local_pos[..., 0]
    safe_depth = jnp.where(jnp.abs(idea_depth) > 1e-6, idea_depth, 1e-6)
    px = jnp.floor(-local_pos[..., 1] * param.fx / safe_depth + param.cx + 0.5).astype(jnp.int32)
    py = jnp.floor(-local_pos[..., 2] * param.fy / safe_depth + param.cy + 0.5).astype(jnp.int32)

    in_frustum = (
        (idea_depth > 0.3) & (idea_depth <= 6.0)
        & (px >= 0) & (px < cols) & (py >= 0) & (py < rows)
    )
    # NaN policy applied IMAGE-side (rows*cols elements, not window-side):
    # identical downstream values
    dimg = jnp.where(jnp.isnan(param.depth),
                     SENS_FAR_DIST if valid_nan else -1.0, param.depth)
    with jax.named_scope("image_lookup"):
        real = dimg[jnp.clip(py, 0, rows - 1), jnp.clip(px, 0, cols - 1)]
    meas_ok = in_frustum & (real > 0.21)

    free = meas_ok & (idea_depth < real - voxel_width)
    hgt_ok = (glb_pos[..., 2] >= ogm_min_h) & (glb_pos[..., 2] <= ogm_max_h)
    occ = meas_ok & (idea_depth >= real - voxel_width) & (idea_depth <= real + voxel_width) & hgt_ok

    inst = jnp.where(occ, VOX_OCCUPIED, jnp.where(free, VOX_FREE, VOX_UNKNOWN))
    if for_motion_planner:
        inst = jnp.where(_robot_sphere_mask(local_size, robot_r2_grids), VOX_FREE, inst)
    return inst.astype(jnp.int8)


@partial(jax.jit, static_argnames=(
    "local_size", "voxel_width", "ogm_min_h", "ogm_max_h",
    "for_motion_planner", "robot_r2_grids"))
def vlp16_update(proj, param: MulScanParam, pvt, *, local_size, voxel_width,
                 ogm_min_h, ogm_max_h, for_motion_planner: bool, robot_r2_grids: int):
    """Multi-ring spherical-projection model (vlp16_fast.cu:8-97, vlp16_helper.h:11-65).

    The "volumetric projection" mode of the paper: every voxel is projected to
    its (theta, phi) bin; voxels farther than one voxel width from the ray's
    axis are left unknown (perpendicular-distance gate, vlp16_helper.h:19-32).
    """
    glb_pos, _ = _window_positions(pvt, local_size, voxel_width)
    local_pos = proj.g2l(glb_pos)
    lx, ly, lz = local_pos[..., 0], local_pos[..., 1], local_pos[..., 2]

    theta = jnp.arctan2(ly, lx)
    theta_idx = jnp.floor((theta - param.theta_min) / param.theta_inc + 0.5).astype(jnp.int32)
    theta_idx = _positive_mod(theta_idx, param.scan_num)

    range_hor = jnp.sqrt(lx * lx + ly * ly)
    phi = jnp.arctan2(lz, range_hor)
    phi_idx = jnp.floor((phi - param.phi_min) / param.phi_inc + 0.5).astype(jnp.int32)
    phi_ok = (phi_idx >= 0) & (phi_idx < param.ring_num)

    # perpendicular distance from the voxel centre to the beam axis
    uz = jnp.sin(phi)
    uxy = jnp.cos(phi)
    ux = uxy * jnp.cos(theta)
    uy = uxy * jnp.sin(theta)
    cxv = uz * ly - uy * lz
    cyv = ux * lz - uz * lx
    czv = uy * lx - ux * ly
    dist2ray = jnp.sqrt(cxv * cxv + cyv * cyv + czv * czv)

    idea_depth = jnp.where(phi_ok & (dist2ray < voxel_width), range_hor, -1.0)

    real = param.rings[jnp.clip(phi_idx, 0, param.ring_num - 1),
                       jnp.clip(theta_idx, 0, param.scan_num - 1)]
    meas_ok = (idea_depth >= 0) & ~jnp.isnan(real) & (real > 0.3)

    # note the asymmetric margins (vlp16_fast.cu:65-77): free only below
    # real-0.3; occupied within +-0.1; the (real-0.3, real-0.1) band is unknown
    free = meas_ok & (idea_depth < real - 0.3)
    hgt_ok = (glb_pos[..., 2] >= ogm_min_h) & (glb_pos[..., 2] <= ogm_max_h)
    occ = meas_ok & (idea_depth >= real - 0.1) & (idea_depth <= real + 0.1) & hgt_ok

    inst = jnp.where(occ, VOX_OCCUPIED, jnp.where(free, VOX_FREE, VOX_UNKNOWN))
    if for_motion_planner:
        inst = jnp.where(_robot_sphere_mask(local_size, robot_r2_grids), VOX_FREE, inst)
    return inst.astype(jnp.int8)
