"""The benchmark's inputs: meshes, lights, material and camera path.

The meshes are frozen copies of the procedural stand-ins the port's
flagship renders (numpy only), so a change to the program's own generators
cannot change what is measured.  The orbit camera follows the reference's
Camera.cpp (a quaternion of yaw about +y times pitch about +x, looking at
the origin).  Both sides get these same arrays: the program through its
scene and camera constructors, the reference as plain tensors.
"""

from __future__ import annotations

import math

import numpy as np


def bumpy_sphere(n_lat, n_lon, radius=1.0, bump=0.15, seed=0):
    """Displaced UV sphere: (vertices [V, 3] f32, indices [T, 3] i32)."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")
    r = radius * (1.0 + bump * np.sin(5 * theta) * np.cos(7 * phi + seed)
                  + 0.5 * bump * np.sin(11 * phi) * np.sin(3 * theta + seed))
    verts = np.stack([r * np.sin(theta) * np.cos(phi), r * np.cos(theta),
                      r * np.sin(theta) * np.sin(phi)], axis=-1)
    verts = verts.reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j % n_lon, (i + 1) * n_lon + j % n_lon
            c = (i + 1) * n_lon + (j + 1) % n_lon
            d = i * n_lon + (j + 1) % n_lon
            if i > 0:
                tris.append([a, d, b])
            if i < n_lat - 1:
                tris.append([b, d, c])
    return verts, np.asarray(tris, np.int32)


def torus_knot(n_seg, n_ring, p=2, q=3, major=1.2, tube=0.35, bump=0.05,
               seed=1):
    """(p, q) torus-knot tube: (vertices [V, 3] f32, indices [T, 3] i32)."""
    t = np.linspace(0.0, 2.0 * np.pi, n_seg, endpoint=False)
    r = np.cos(q * t) + 2.0
    center = np.stack([major * 0.5 * r * np.cos(p * t),
                       major * 0.5 * r * np.sin(p * t),
                       major * 0.5 * -np.sin(q * t)], axis=1)
    tangent = np.roll(center, -1, axis=0) - np.roll(center, 1, axis=0)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    normal = np.cross(tangent, np.array([0.0, 0.0, 1.0]))
    bad = np.linalg.norm(normal, axis=1) < 1e-6
    normal[bad] = np.cross(tangent[bad], np.array([0.0, 1.0, 0.0]))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    binorm = np.cross(tangent, normal)
    phase = np.random.default_rng(seed).uniform(0.0, 2.0 * np.pi)
    theta = np.linspace(0.0, 2.0 * np.pi, n_ring, endpoint=False)
    disp = 1.0 + bump * np.sin(6.0 * theta)[None, :] * np.cos(
        8.0 * t + phase)[:, None]
    radius = tube * disp
    verts = (center[:, None, :] + radius[:, :, None] * (
        np.cos(theta)[None, :, None] * normal[:, None, :]
        + np.sin(theta)[None, :, None] * binorm[:, None, :]))
    verts = verts.reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(n_seg):
        for j in range(n_ring):
            a = i * n_ring + j
            b = ((i + 1) % n_seg) * n_ring + j
            c = ((i + 1) % n_seg) * n_ring + (j + 1) % n_ring
            d = i * n_ring + (j + 1) % n_ring
            tris.append([a, b, c])
            tris.append([a, c, d])
    return verts, np.asarray(tris, np.int32)


def mesh(spec):
    """The mesh a configuration's "mesh" entry names, sized as the port's
    scene builders size it from a triangle target."""
    n = spec["n_tris_target"]
    if spec["family"] == "bumpy_sphere":
        n_lat = max(int(np.sqrt(n / 4.0)), 8)
        return bumpy_sphere(n_lat, 2 * n_lat)
    if spec["family"] == "torus_knot":
        n_ring = max(int(np.sqrt(n / 16.0)), 8)
        return torus_knot(8 * n_ring, n_ring)
    raise ValueError(f"unknown mesh family {spec['family']!r}")


def _quat(axis, deg):
    h = math.radians(deg) * 0.5
    s = math.sin(h)
    return np.array([math.cos(h), axis[0] * s, axis[1] * s, axis[2] * s])


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw])


def _rotate(q, v):
    w, u = q[0], q[1:]
    v = np.asarray(v, np.float64)
    return 2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v + 2.0 * w * \
        np.cross(u, v)


def orbit(yaw_deg, pitch_deg, radius, fov_deg):
    """The camera of an orbit state (Camera.cpp:80-101), as float32 arrays:
    {"position", "direction", "up", "fov_deg"}."""
    rot = _qmul(_quat((0.0, 1.0, 0.0), yaw_deg), _quat((1.0, 0.0, 0.0),
                                                        pitch_deg))
    pos = _rotate(rot, (0.0, 0.0, radius))
    return {"position": pos.astype(np.float32),
            "direction": (-pos / max(np.linalg.norm(pos), 1e-20)).astype(
                np.float32),
            "up": _rotate(rot, (0.0, 1.0, 0.0)).astype(np.float32),
            "fov_deg": np.float32(fov_deg)}


def drag_path(rng, n, step_deg, pitch_max_deg, yaw0, pitch0):
    """`n` orbit states of a drag: each frame turns the yaw by step_deg in
    a direction drawn from `rng` (a run of 8-24 frames each way) and the
    pitch by half that, turning back at +-pitch_max_deg.  Every frame moves
    the camera by the same angle, so every seed renders the same amount of
    motion in another order."""
    states = []
    yaw, pitch = yaw0, pitch0
    sy, sp, left = 1.0, 1.0, 0
    for _ in range(n):
        if left == 0:
            sy = float(rng.choice([-1.0, 1.0]))
            sp = float(rng.choice([-1.0, 1.0]))
            left = int(rng.integers(8, 25))
        left -= 1
        yaw = (yaw + sy * step_deg) % 360.0
        if abs(pitch + sp * 0.5 * step_deg) > pitch_max_deg:
            sp = -sp
        pitch += sp * 0.5 * step_deg
        states.append((yaw, pitch))
    return states
