"""Rigid transforms and voxel-grid frame conversions.

Counterpart of the reference's SE3/Projection substrate
(/root/reference/include/cuda_toolkit/se3.cuh, projection.h:6-33) and of the
LocMap frame math (/root/reference/include/map_structure/local_batch.h:128-301).

Everything here is pure JAX and shape-polymorphic via broadcasting: points are
(..., 3) float32 arrays, voxel coordinates are (..., 3) int32 arrays.

Coordinate frames:
  * glb  — integer voxel coordinates of the world, centre-anchored
           (pos2coord rounds p/width + 0.5, local_batch.h:249-258).
  * loc  — glb minus the window pivot ``pvt`` (scrolling robot-centred window).
  * canvas — glb minus the canvas origin (window inflated by the EDT cutoff,
           block-aligned); replaces the reference's packed "wave range" frame
           (local_batch.h:159-166) — no bit packing is needed because
           this engine never does packed 64-bit atomics.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def quat_to_rot(qw, qx, qy, qz):
    """Quaternion (w,x,y,z) to 3x3 rotation matrix (numpy, host-side).

    Mirrors the quaternion ctor of cudaMat::SE3 (se3.cuh:24).
    """
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ],
        dtype=np.float32,
    )


def rot_to_quat(R):
    """3x3 rotation matrix to quaternion (w,x,y,z) (numpy, host-side).

    Shepperd's method: picks the largest of the four squared components
    before dividing, so it is stable for every rotation."""
    R = np.asarray(R, np.float64)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    cand = np.array([tr, R[0, 0], R[1, 1], R[2, 2]])
    k = int(np.argmax(cand))
    if k == 0:
        s = np.sqrt(1.0 + tr) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    elif k == 1:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
    elif k == 2:
        s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.asarray(q, np.float64)
    if q[0] < 0:
        q = -q
    return (q / np.linalg.norm(q)).astype(np.float32)


def _matmul(a, b):
    """a @ b in full float32.  The precision is required: at default
    precision a GPU may run a float32 product in TF32 (about 3 decimal
    digits), a millimetre error at 8 m that moves points across voxel
    boundaries and makes the map differ from the CPU's."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def rigid_transform(pts, rot, trans):
    """pts @ rot.T + trans (sensor -> world) in full float32 (see _matmul)."""
    return _matmul(pts, rot.T) + trans


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Projection:
    """Sensor pose: local(sensor)->global rigid transform and its inverse.

    Reference: Projection{L2G, G2L, origin} built from the odometry transform
    (projection.h:14-33).  ``rot``/``trans`` are the L2G transform.
    """

    rot: jnp.ndarray  # (3,3) float32, sensor->world rotation
    trans: jnp.ndarray  # (3,) float32, sensor origin in world

    def l2g(self, pts):
        return rigid_transform(pts, self.rot, self.trans)

    def g2l(self, pts):
        return _matmul(pts - self.trans, self.rot)

    @property
    def origin(self):
        return self.trans

    def tree_flatten(self):
        return (self.rot, self.trans), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @staticmethod
    def from_pose(position, quat_wxyz) -> "Projection":
        """Build from a (3,) position and (w,x,y,z) quaternion (host-side)."""
        rot = quat_to_rot(*[float(q) for q in quat_wxyz])
        return Projection(
            rot=jnp.asarray(rot, jnp.float32),
            trans=jnp.asarray(np.asarray(position, np.float32)),
        )

    @staticmethod
    def identity() -> "Projection":
        return Projection(rot=jnp.eye(3, dtype=jnp.float32), trans=jnp.zeros(3, jnp.float32))

    def compose_matrix(self, T: np.ndarray) -> "Projection":
        """Right-compose with a 4x4 matrix: new_L2G = L2G @ T.

        Used for the cow-lady vicon->cam extrinsic T_V_C
        (parameters.h:112-118): the bag gives the vicon-marker pose, the
        sensor is the camera, so proj_cam = proj_vicon.compose_matrix(T_V_C).
        """
        T = np.asarray(T, np.float32)
        new_rot = _matmul(self.rot, jnp.asarray(T[:3, :3]))
        new_trans = _matmul(self.rot, jnp.asarray(T[:3, 3])) + self.trans
        return Projection(rot=new_rot, trans=new_trans)


def pos2coord(p, voxel_width):
    """Metres -> global voxel coordinate; centre-anchored rounding.

    Reference: local_batch.h:249-258 (floor(p/width + 0.5)).
    """
    return jnp.floor(p / voxel_width + 0.5).astype(jnp.int32)


def coord2pos(c, voxel_width):
    """Global voxel coordinate -> metres of the voxel centre (local_batch.h:259-267)."""
    return c.astype(jnp.float32) * voxel_width


def glb2loc(c, pvt):
    return c - pvt


def loc2glb(c, pvt):
    return c + pvt


def calculate_pivot(map_center, voxel_width, local_size):
    """Window pivot so the window is centred on the robot.

    Reference: calculate_pivot_origin (local_batch.h:128-142).  Returns the
    glb coordinate of the window's (0,0,0) corner.  Host-side (numpy).
    """
    center = np.floor(np.asarray(map_center) / voxel_width + 0.5).astype(np.int64)
    return (center - np.asarray(local_size) // 2).astype(np.int32)


def local_coord_grid(local_size):
    """Dense (X,Y,Z,3) int32 grid of local voxel coordinates."""
    X, Y, Z = (int(s) for s in local_size)
    gx = jax.lax.broadcasted_iota(jnp.int32, (X, Y, Z), 0)
    gy = jax.lax.broadcasted_iota(jnp.int32, (X, Y, Z), 1)
    gz = jax.lax.broadcasted_iota(jnp.int32, (X, Y, Z), 2)
    return jnp.stack([gx, gy, gz], axis=-1)


def squared_dist(c1, c2):
    """Integer squared distance between int coordinate triples (...,3)."""
    d = (c1 - c2).astype(jnp.int32)
    return jnp.sum(d * d, axis=-1)


def inside_volume(c, size):
    """Boolean mask: coordinate triple within [0, size) (local_batch.h:113-126)."""
    size = jnp.asarray(size, jnp.int32)
    return jnp.all((c >= 0) & (c < size), axis=-1)


def block_key_of(glb_coord):
    """Voxel-block key (floor division by VB_WIDTH) of a glb coordinate.

    Reference: get_VB_key (voxmap_utils.cuh:93-101) — the shift/mask trick
    there is exactly floor division for negative-capable ints.
    """
    return jnp.floor_divide(glb_coord, 8)


def sub_block_index(glb_coord):
    """Index of a voxel inside its 8^3 block (voxmap_utils.cuh:103-109)."""
    return jnp.mod(glb_coord, 8)
