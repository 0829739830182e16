"""Parallel point-cloud ray casting (forward sensor model).

Dense redesign of the reference's atomic scatter ray caster
(/root/reference/src/kernel/point_cloud/pntcld_raycast.cu:9-117,
 ray_cast.h:56-144):

* ``registerLocObs``'s per-point atomicAdd endpoint scatter becomes one
  deterministic XLA ``scatter-add`` over all points.
* ``freeLocObs``'s per-thread Amanatides–Woo DDA walk becomes a
  ``lax.scan`` over a static step bound, vectorised over all rays: each step
  advances every live ray by exactly one voxel boundary (the classic DDA
  min-tMax rule), gathers the endpoint-occupancy grid for the early-stop test,
  and scatter-adds the per-step visit mask.  Atomics disappear — scatter-add
  is an associative reduction.
* ``getAllocKeys``'s count-sign classification is a dense elementwise map.

Rays are clamped to 0.707 * window_x * voxel_width exactly like the reference
(pntcld_raycast.cu:79).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from ..utils import geometry as geo
from ..utils.constants import VOX_FREE, VOX_OCCUPIED, VOX_UNKNOWN


def max_dda_steps(local_size) -> int:
    """Static step bound: a ray of length .707*X voxels crosses at most
    ~sqrt(3)*.707*X + 3 voxel boundaries."""
    return int(math.ceil(0.707 * local_size[0] * math.sqrt(3.0))) + 4


def panorama_bins(local_size) -> tuple[int, int]:
    """Smallest power-of-two (theta, phi) binning that still resolves one
    voxel at the maximum ray length (0.707*X voxels): finer bins only grow
    the gather source without adding information."""
    need = 2 * math.pi * 0.707 * local_size[0]
    n_theta = 1 << max(7, math.ceil(math.log2(need)))
    return min(n_theta, 2048), min(n_theta // 2, 1024)


@partial(
    jax.jit,
    static_argnames=("local_size", "voxel_width", "ogm_min_h", "ogm_max_h",
                     "for_motion_planner", "robot_r2_grids", "n_theta", "n_phi"),
)
def pointcloud_project(points, valid, origin, pvt, *, local_size, voxel_width,
                       ogm_min_h, ogm_max_h, for_motion_planner: bool,
                       robot_r2_grids: int, n_theta: int = 512, n_phi: int = 256):
    """Dense projective pointcloud OGM update (the default raycast mode).

    Same contract as `pointcloud_raycast`, but free space is carved by a
    spherical min-range image instead of per-ray DDA walks: endpoints are
    registered exactly (one small scatter, mirroring registerLocObs),
    the cloud is binned into a (theta, phi) min-depth panorama, and every
    window voxel tests its own range against its bin — a pure dense
    gather/compare, the same inverse-model structure as the reference's own
    projection sensors (hokuyo/realsense/vlp16 kernels): per-voxel-visit
    scatter-adds (2M+ scatter indices per frame in the exact DDA walk) are
    replaced by dense per-voxel math.  Early stop at occupied surfaces falls
    out of the min-depth binning.  Divergence from exact DDA (documented):
    free-space counts are per-bin ray counts rather than per-cell visit
    counts, and voxels whose centre's bin holds no ray stay unknown.
    """
    X, Y, Z = local_size
    size = jnp.asarray(local_size, jnp.int32)

    glb_crd = geo.pos2coord(points, voxel_width)
    loc_crd = glb_crd - pvt

    # ---- exact endpoint registration (pntcld_raycast.cu:83-102) ----------
    hgt_ok = (points[..., 2] >= ogm_min_h) & (points[..., 2] <= ogm_max_h)
    inside = geo.inside_volume(loc_crd, size)
    reg_mask = valid & hgt_ok & inside
    flat = (loc_crd[:, 0] * (Y * Z) + loc_crd[:, 1] * Z + loc_crd[:, 2])
    flat = jnp.where(reg_mask, flat, 0)
    endpoint_cnt = jnp.zeros((X * Y * Z,), jnp.int32)
    endpoint_cnt = endpoint_cnt.at[flat].add(jnp.where(reg_mask, 1, 0))
    endpoint_cnt = endpoint_cnt.reshape(X, Y, Z)

    # ---- spherical min-range panorama ------------------------------------
    rel = points - origin[None, :]
    r = jnp.linalg.norm(rel, axis=-1)
    theta = jnp.arctan2(rel[:, 1], rel[:, 0])
    rho = jnp.sqrt(rel[:, 0] ** 2 + rel[:, 1] ** 2)
    phi = jnp.arctan2(rel[:, 2], rho)
    bt = jnp.clip((theta + jnp.pi) * (n_theta / (2 * jnp.pi)), 0, n_theta - 1).astype(jnp.int32)
    bp = jnp.clip((phi + jnp.pi / 2) * (n_phi / jnp.pi), 0, n_phi - 1).astype(jnp.int32)
    bin_id = jnp.where(valid, bt * n_phi + bp, 0)

    big = jnp.float32(1e30)
    depth = jnp.full((n_theta * n_phi,), big, jnp.float32)
    depth = depth.at[bin_id].min(jnp.where(valid, r, big))
    cnt = jnp.zeros((n_theta * n_phi,), jnp.int32)
    cnt = cnt.at[bin_id].add(jnp.where(valid, 1, 0))

    # ---- dense free-space carve ------------------------------------------
    loc = geo.local_coord_grid(local_size)
    vpos = geo.coord2pos(loc + pvt[None, None, None, :], voxel_width)
    vrel = vpos - origin[None, None, None, :]
    vr = jnp.linalg.norm(vrel, axis=-1)
    vtheta = jnp.arctan2(vrel[..., 1], vrel[..., 0])
    vrho = jnp.sqrt(vrel[..., 0] ** 2 + vrel[..., 1] ** 2)
    vphi = jnp.arctan2(vrel[..., 2], vrho)
    vbt = jnp.clip((vtheta + jnp.pi) * (n_theta / (2 * jnp.pi)), 0, n_theta - 1).astype(jnp.int32)
    vbp = jnp.clip((vphi + jnp.pi / 2) * (n_phi / jnp.pi), 0, n_phi - 1).astype(jnp.int32)

    with jax.named_scope("panorama_lookup"):
        vbin = vbt * n_phi + vbp
        vdepth = depth[vbin]
        vcnt = cnt[vbin]
    max_length = 0.707 * X * voxel_width
    freed = (vdepth < big) & (vr + voxel_width < vdepth) & (vr <= max_length)

    ray_count = jnp.where(
        endpoint_cnt > 0, endpoint_cnt,
        jnp.where(freed, -jnp.minimum(vcnt, 10), 0),
    )

    if for_motion_planner:
        half = jnp.asarray([s // 2 for s in local_size], jnp.int32)
        d = loc - half
        sphere = jnp.sum(d * d, axis=-1) <= robot_r2_grids
        ray_count = jnp.where(sphere, -1, ray_count)

    inst_type = jnp.where(
        ray_count > 0, VOX_OCCUPIED, jnp.where(ray_count < 0, VOX_FREE, VOX_UNKNOWN)
    ).astype(jnp.int8)
    return inst_type, ray_count


@partial(
    jax.jit,
    static_argnames=("local_size", "voxel_width", "ogm_min_h", "ogm_max_h",
                     "for_motion_planner", "robot_r2_grids"),
)
def pointcloud_raycast(points, valid, origin, pvt, *, local_size, voxel_width,
                       ogm_min_h, ogm_max_h, for_motion_planner: bool,
                       robot_r2_grids: int):
    """Full pointcloud local-OGM update.

    Args:
      points: [N,3] float32 endpoint positions in WORLD frame (callers apply
        proj.l2g first — mirrors pntcld_raycast.cu:77,93).
      valid:  [N] bool mask for padded points.
      origin: (3,) float32 sensor origin in world frame.
      pvt:    (3,) int32 window pivot.

    Returns (inst_type int8 [X,Y,Z], ray_count int32 [X,Y,Z]).
    """
    X, Y, Z = local_size
    size = jnp.asarray(local_size, jnp.int32)
    n = points.shape[0]

    glb_crd = geo.pos2coord(points, voxel_width)
    loc_crd = glb_crd - pvt

    # ---- register endpoints (pntcld_raycast.cu:83-102) -------------------
    hgt_ok = (points[..., 2] >= ogm_min_h) & (points[..., 2] <= ogm_max_h)
    inside = geo.inside_volume(loc_crd, size)
    reg_mask = valid & hgt_ok & inside

    flat = (loc_crd[:, 0] * (Y * Z) + loc_crd[:, 1] * Z + loc_crd[:, 2])
    flat = jnp.where(reg_mask, flat, 0)

    ray_count = jnp.zeros((X * Y * Z,), jnp.int32)
    ray_count = ray_count.at[flat].add(jnp.where(reg_mask, 1, 0))
    endpoint_occ = jnp.zeros((X * Y * Z,), jnp.bool_).at[flat].max(reg_mask)

    # ---- free-space DDA walk (ray_cast.h:56-144) -------------------------
    p0 = origin
    p0_idx = geo.pos2coord(p0, voxel_width)
    p1_idx = glb_crd
    direction = points - p0[None, :]
    seg_len = jnp.linalg.norm(direction, axis=-1)
    safe_len = jnp.maximum(seg_len, 1e-9)
    dirn = direction / safe_len[:, None]
    max_length = 0.707 * X * voxel_width

    step = jnp.where(dirn > 0, 1, jnp.where(dirn < 0, -1, 0)).astype(jnp.int32)
    vw = jnp.float32(voxel_width)
    border = p0_idx[None, :].astype(jnp.float32) * vw + step.astype(jnp.float32) * vw * 0.5
    big = jnp.float32(3.4e38)
    t_max0 = jnp.where(step != 0, (border - p0[None, :]) / jnp.where(step != 0, dirn, 1.0), big)
    t_delta = jnp.where(step != 0, vw / jnp.abs(jnp.where(step != 0, dirn, 1.0)), big)

    same_cell = jnp.all(p1_idx == p0_idx[None, :], axis=-1)

    def visit(counts, crd_loc, mask):
        """Decrement ray_count at crd for live rays inside the window."""
        ins = geo.inside_volume(crd_loc, size)
        f = jnp.where(mask & ins,
                      crd_loc[:, 0] * (Y * Z) + crd_loc[:, 1] * Z + crd_loc[:, 2], 0)
        return counts.at[f].add(jnp.where(mask & ins, -1, 0))

    # initial visit of the origin voxel (ray_cast.h:62) — only for rays that
    # are not already blocked there by a registered endpoint
    p0_loc = (p0_idx - pvt)[None, :].repeat(n, 0)
    p0_flat = jnp.clip(p0_loc[:, 0] * (Y * Z) + p0_loc[:, 1] * Z + p0_loc[:, 2], 0, X * Y * Z - 1)
    p0_occ = endpoint_occ[p0_flat] & geo.inside_volume(p0_loc, size)
    ray_count = visit(ray_count, p0_loc, valid & ~p0_occ)

    done0 = same_cell | ~valid

    def body(carry, _):
        counts, cur, t_max, done = carry
        # axis of the nearest voxel boundary (ray_cast.h:104-114)
        axis = jnp.argmin(t_max, axis=-1)
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        new_cur = cur + onehot * step
        new_tmax = t_max + onehot.astype(t_max.dtype) * t_delta

        crd_loc = new_cur - pvt
        ins = geo.inside_volume(crd_loc, size)
        f = jnp.where(ins, crd_loc[:, 0] * (Y * Z) + crd_loc[:, 1] * Z + crd_loc[:, 2], 0)
        hit_occ = endpoint_occ[f] & ins  # stop at endpoint-occupied voxels

        live = ~done
        dec = live & ~hit_occ
        counts = counts.at[jnp.where(dec & ins, f, 0)].add(jnp.where(dec & ins, -1, 0))

        reached = jnp.all(new_cur == p1_idx, axis=-1)
        t_next = jnp.min(new_tmax, axis=-1)
        out_of_range = (t_next > max_length) | (t_next > seg_len)
        new_done = done | hit_occ | reached | out_of_range

        cur = jnp.where(live[:, None], new_cur, cur)
        t_max = jnp.where(live[:, None], new_tmax, t_max)
        return (counts, cur, t_max, new_done), None

    (ray_count, _, _, _), _ = jax.lax.scan(
        body,
        (ray_count, p0_idx[None, :].repeat(n, 0), t_max0, done0),
        None,
        length=max_dda_steps(local_size),
    )

    ray_count = ray_count.reshape(X, Y, Z)

    # ---- classification (getAllocKeys, pntcld_raycast.cu:21-63) ---------
    if for_motion_planner:
        half = jnp.asarray([s // 2 for s in local_size], jnp.int32)
        d = geo.local_coord_grid(local_size) - half
        sphere = jnp.sum(d * d, axis=-1) <= robot_r2_grids
        ray_count = jnp.where(sphere, -1, ray_count)

    inst_type = jnp.where(
        ray_count > 0, VOX_OCCUPIED, jnp.where(ray_count < 0, VOX_FREE, VOX_UNKNOWN)
    ).astype(jnp.int8)
    return inst_type, ray_count
