"""Synthetic worlds + sensor simulators and npz replay.

The reference's de-facto fixtures are five public rosbags replayed through
launch files (README.md:102-145).  Those bags are not available here, so this
module provides (a) procedural worlds with exact analytic sensor simulation —
used by the unit/e2e tests and the benchmark — and (b) a simple npz replay
format (`frames.npz` with per-frame pose + sensor payload) into which real
bags can be converted offline.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..utils import geometry as geo


@dataclasses.dataclass
class BoxWorld:
    """Axis-aligned boxes [M, 2, 3] (ll, ur) in metres + bounding walls."""

    boxes: np.ndarray
    bounds_ll: np.ndarray
    bounds_ur: np.ndarray

    @staticmethod
    def corridor(seed=0, n_pillars=6, extent=8.0, height=3.0):
        rng = np.random.default_rng(seed)
        boxes = []
        for _ in range(n_pillars):
            c = rng.uniform(-extent * 0.7, extent * 0.7, 2)
            w = rng.uniform(0.2, 0.8, 2)
            h = rng.uniform(0.8, height, 1)[0]
            boxes.append([[c[0] - w[0], c[1] - w[1], 0.0], [c[0] + w[0], c[1] + w[1], h]])
        return BoxWorld(
            boxes=np.asarray(boxes, np.float32),
            bounds_ll=np.asarray([-extent, -extent, 0.0], np.float32),
            bounds_ur=np.asarray([extent, extent, height], np.float32),
        )

    def occupied(self, pts):
        """Boolean: world points inside any box or outside the bounds walls."""
        pts = np.asarray(pts)
        inside_box = np.zeros(pts.shape[:-1], bool)
        for ll, ur in self.boxes:
            inside_box |= np.all((pts >= ll) & (pts <= ur), -1)
        outside = np.any(pts < self.bounds_ll, -1) | np.any(pts > self.bounds_ur, -1)
        return inside_box | outside

    # -- analytic sensors ----------------------------------------------
    def ray_march(self, origin, dirs, max_range=30.0, step=0.02):
        """First-hit range along each direction, on the same sample grid as
        dense marching (t = step, 2*step, ... < max_range; first sample
        inside any box — inclusive bounds — or strictly outside the world
        walls).

        Implemented analytically (slab ray-AABB intervals in float64 +
        searchsorted onto the float32 sample grid) instead of materialising
        [rays, samples, 3] points: dense marching cost 22 s/frame at the
        131 k-ray bench scale, ~1000x this.  `ray_march_dense` keeps the
        original formulation; tests/test_datasets.py pins exact agreement
        on the fixture worlds (disagreement requires a sample within ~1 ulp
        of a box face — measure-zero for the random worlds used)."""
        o = np.asarray(origin, np.float64)
        d = np.asarray(dirs, np.float64)
        R = d.shape[0]
        ts = np.arange(step, max_range, step, dtype=np.float32)
        n_t = len(ts)
        ts64 = ts.astype(np.float64)

        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d  # +-inf where d==0 (IEEE semantics)

            def interval_k(tn, tf, strict_lo=False):
                """First sample index inside [tn, tf] (or (tn, ...) when
                strict_lo), n_t when none."""
                side = "right" if strict_lo else "left"
                k0 = np.searchsorted(ts64, tn, side=side)
                kk = np.minimum(k0, n_t - 1)
                ok = (k0 < n_t) & (ts64[kk] <= tf)
                return np.where(ok, k0, n_t)

            def slab(ll, ur):
                # d==0 outside the slab: +-inf same sign -> empty interval;
                # inside: -inf/+inf -> full.  NaN (o exactly on a face with
                # d==0) counts inside, matching p >= ll & p <= ur.
                t0 = (np.asarray(ll, np.float64)[None, :] - o[None, :]) * inv
                t1 = (np.asarray(ur, np.float64)[None, :] - o[None, :]) * inv
                lo = np.where(np.isnan(np.fmin(t0, t1)), -np.inf,
                              np.fmin(t0, t1))
                hi = np.where(np.isnan(np.fmax(t0, t1)), np.inf,
                              np.fmax(t0, t1))
                return lo.max(axis=1), hi.min(axis=1)

            first_k = np.full(R, n_t, np.int64)
            for ll, ur in self.boxes:
                tn, tf = slab(ll, ur)
                first_k = np.minimum(first_k, interval_k(tn, tf))
            # outside the bounding walls (STRICT inequalities): occupied for
            # every sample strictly past the world-box exit, and before a
            # (re)entry for rays starting outside
            tn, tf = slab(self.bounds_ll, self.bounds_ur)
            first_k = np.minimum(first_k, interval_k(tf, np.inf,
                                                     strict_lo=True))
            outside0 = np.any(o < self.bounds_ll.astype(np.float64)) or \
                np.any(o > self.bounds_ur.astype(np.float64))
            if outside0:
                first_k = np.minimum(first_k, interval_k(
                    np.full(R, -np.inf), np.minimum(tn, np.inf) - 1e-12))

        hit = first_k < n_t
        return np.where(hit, ts[np.minimum(first_k, n_t - 1)],
                        np.nan).astype(np.float32)

    def ray_march_dense(self, origin, dirs, max_range=30.0, step=0.02):
        """Original dense-sampling marcher (the analytic ray_march's oracle;
        O(rays x samples) memory/compute — test scale only)."""
        origin = np.asarray(origin, np.float32)
        dirs = np.asarray(dirs, np.float32)
        t = np.arange(step, max_range, step, dtype=np.float32)
        pts = origin[None, None, :] + dirs[:, None, :] * t[None, :, None]
        occ = self.occupied(pts)  # [R, T]
        first = occ.argmax(1)
        hit = occ.any(1)
        return np.where(hit, t[first], np.nan).astype(np.float32)

    def scan_2d(self, proj: geo.Projection, n_beams=360, theta_min=-np.pi,
                theta_inc=None, max_range=30.0):
        """Simulated planar LiDAR in the sensor frame (z=0 plane)."""
        if theta_inc is None:
            theta_inc = 2 * np.pi / n_beams
        th = theta_min + np.arange(n_beams) * theta_inc
        dirs_local = np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], -1)
        rot = np.asarray(proj.rot)
        dirs_world = dirs_local @ rot.T
        ranges = self.ray_march(np.asarray(proj.trans), dirs_world, max_range)
        return ranges, theta_min, theta_inc

    def pointcloud(self, proj: geo.Projection, n_rays=4096, max_range=12.0, seed=0):
        """Simulated omnidirectional pointcloud: endpoints in SENSOR frame."""
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(n_rays, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        rot = np.asarray(proj.rot)
        ranges = self.ray_march(np.asarray(proj.trans), v @ rot.T, max_range)
        ok = ~np.isnan(ranges)
        return (v[ok] * ranges[ok, None]).astype(np.float32)

    def depth_image(self, proj: geo.Projection, rows=48, cols=64, fx=40.0,
                    fy=40.0, cx=None, cy=None, max_range=12.0):
        """Simulated depth camera (reference frame: x fwd, y left, z up;
        camera_helper.h:10-36).  Returns depth [rows, cols]."""
        cx = cols / 2 if cx is None else cx
        cy = rows / 2 if cy is None else cy
        px, py = np.meshgrid(np.arange(cols), np.arange(rows))
        y = (cx - px) / fx
        z = (cy - py) / fy
        d = np.stack([np.ones_like(y), y, z], -1).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        rot = np.asarray(proj.rot)
        rng = self.ray_march(np.asarray(proj.trans), d.reshape(-1, 3) @ rot.T, max_range)
        # reference depth is the x (forward) component, not the slant range
        fwd = rng * d.reshape(-1, 3)[:, 0]
        return fwd.reshape(rows, cols).astype(np.float32), fx, fy, cx, cy

    def multiscan(self, proj: geo.Projection, ring_num=16, scan_num=360,
                  phi_min=np.deg2rad(-15.0), phi_inc=np.deg2rad(2.0),
                  theta_min=-np.pi, theta_inc=None, max_range=25.0):
        """Simulated 16-ring spinning LiDAR range image [ring_num, scan_num]."""
        if theta_inc is None:
            theta_inc = 2 * np.pi / scan_num
        th = theta_min + np.arange(scan_num) * theta_inc
        ph = phi_min + np.arange(ring_num) * phi_inc
        T, P = np.meshgrid(th, ph)
        dirs = np.stack([np.cos(P) * np.cos(T), np.cos(P) * np.sin(T), np.sin(P)], -1)
        rot = np.asarray(proj.rot)
        rng = self.ray_march(np.asarray(proj.trans), dirs.reshape(-1, 3) @ rot.T, max_range)
        # reference stores horizontal range (vlp16_helper.h:64): r*cos(phi)
        horiz = rng * np.cos(P).reshape(-1)
        return horiz.reshape(ring_num, scan_num).astype(np.float32), theta_min, theta_inc, phi_min, phi_inc


def circular_trajectory(n_frames=20, radius=2.0, height=1.0, closed=False):
    """Poses orbiting the origin, always facing forward along the orbit.

    closed: spread the frames over the FULL circle so frame n-1 is adjacent
    to frame 0 — replaying the sequence wraps with an ordinary scroll
    instead of a teleport-scale jump (bench passes then plan as one scan
    program)."""
    out = []
    for i in range(n_frames):
        a = 2 * np.pi * i / max(n_frames, 1) * (1.0 if closed else 0.5)
        pos = np.asarray([radius * np.cos(a), radius * np.sin(a), height], np.float32)
        yaw = a + np.pi / 2
        quat = (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
        out.append(geo.Projection.from_pose(pos, quat))
    return out


def save_frames_npz(path, frames: List[dict]):
    """Persist a replayable frame sequence (offline bag conversion target)."""
    flat = {}
    for i, fr in enumerate(frames):
        for k, v in fr.items():
            flat[f"{i:05d}/{k}"] = v
    np.savez_compressed(path, **flat)


def load_frames_npz(path) -> List[dict]:
    raw = np.load(path, allow_pickle=False)
    frames: dict = {}
    for k in raw.files:
        idx, field = k.split("/", 1)
        frames.setdefault(int(idx), {})[field] = raw[k]
    return [frames[i] for i in sorted(frames)]
