"""Camera pose math (PyTorch port of the parts of
`nerf_from_image_tpu/core/pose.py` that inversion and GAN training use).

cam2world <-> world2cam inversion with a scale carried in entry [3, 3],
quaternion -> rotation matrix, the (z0, t2, s, q) pose parameterization of
the inversion optimizer and its inverse, the discriminator's 13-D pose
conditioning, the geodesic rotation distance and `perturb_poses` (the
training CLI's --perturb_poses). Differentiable where the reference is;
`matrix_to_quaternion` and `perturb_poses` are host-side numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def invert_space(mat: torch.Tensor) -> torch.Tensor:
    """Converts cam2world <-> world2cam for scaled rigid transforms.

    The [3, 3] entry carries an isotropic scale (ortho cameras); the output
    has R^T / s in the rotation block and [3, 3] = 1.
    """
    scale = mat[..., 3:4, 3:4]
    rot = mat[..., :3, :3].transpose(-2, -1) / scale
    t = -torch.sum(mat[..., :3, :3] / scale * mat[..., :3, None, 3], dim=-2)
    top = torch.cat((rot, t[..., None]), dim=-1)
    bottom = torch.zeros_like(mat[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat((top, bottom), dim=-2)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> (B, 3, 3) rotation matrix, by
    rotating the identity basis: v + 2(w (u x v) + u x (u x v))."""
    w = q[..., :1]
    u = q[..., 1:]
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(
        q.shape[:-1] + (3, 3))
    u_rows = u[..., None, :].expand_as(eye)
    uv = torch.linalg.cross(u_rows, eye, dim=-1)  # rows: u x e_i
    uuv = torch.linalg.cross(u_rows, uv, dim=-1)
    return eye + 2.0 * (w[..., None] * uv + uuv)


def matrix_to_quaternion(matrix: np.ndarray) -> np.ndarray:
    """Rotation (or scaled 4x4) matrix -> quaternion (w, x, y, z).
    Host-side."""
    m = np.array(matrix, dtype=np.float64, copy=True)
    if m.shape[-1] == 3:
        m4 = np.eye(4)
        m4[:3, :3] = m
        m = m4
    m = m[:4, :4]
    q = np.empty((4,))
    t = np.trace(m)
    if t > m[3, 3]:
        q[0] = t
        q[3] = m[1, 0] - m[0, 1]
        q[2] = m[0, 2] - m[2, 0]
        q[1] = m[2, 1] - m[1, 2]
    else:
        i, j, k = 0, 1, 2
        if m[1, 1] > m[0, 0]:
            i, j, k = 1, 2, 0
        if m[2, 2] > m[i, i]:
            i, j, k = 2, 0, 1
        t = m[i, i] - (m[j, j] + m[k, k]) + m[3, 3]
        q[i] = t
        q[j] = m[i, j] + m[j, i]
        q[k] = m[k, i] + m[i, k]
        q[3] = m[k, j] - m[j, k]
        q = q[[3, 0, 1, 2]]
    q *= 0.5 / np.sqrt(t * m[3, 3])
    return q


def _flip(mat: torch.Tensor) -> torch.Tensor:
    """Negates columns 1 and 2 of the top three rows."""
    sign = torch.ones((4, 4), dtype=mat.dtype, device=mat.device)
    sign[:3, 1:] = -1.0
    return mat * sign


def pose_to_matrix(z0: Optional[torch.Tensor], t2: torch.Tensor,
                   s: torch.Tensor, q: torch.Tensor, camera_flipped: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(z0, t2, s, quaternion) -> cam2world (B, 4, 4) (+ focal (B,) for
    perspective).

    Perspective: f = 1 + exp(z0); t3 = (t2 / s, f / s); the focal
    returned is f / 2. Ortho (z0 None): t3 = (t2, 10); the matrix is
    divided by s (scale in [3, 3]); focal None.
    """
    rot = quaternion_to_matrix(q)
    if z0 is not None:
        f = 1.0 + torch.exp(z0)
        t3 = torch.cat((t2 / s[:, None], (f / s)[:, None]), dim=-1)
    else:
        f = None
        t3 = torch.cat((t2, torch.full_like(t2[:, :1], 10.0)), dim=-1)
    trans = torch.sum(t3[:, None, :] * rot, dim=-1)
    top = torch.cat((rot, trans[..., None]), dim=-1)
    bottom = torch.zeros_like(top[:, :1])
    bottom[..., 3] = 1.0
    mat = torch.cat((top, bottom), dim=1)
    if camera_flipped:
        mat = _flip(mat)
    if f is None:
        return mat / s[:, None, None], None
    return mat, f / 2.0


def matrix_to_pose(cam2world: torch.Tensor,
                   focal_length: Optional[torch.Tensor],
                   camera_flipped: bool
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """cam2world (+ focal) -> (z0, t2, s, quaternion). The quaternion is
    computed on the host (numpy)."""
    mat = _flip(cam2world) if camera_flipped else cam2world
    m_inv = invert_space(mat)
    t3 = -m_inv[:, :3, 3]
    if focal_length is not None:
        z0 = torch.log(2.0 * focal_length - 1.0)
        s = 2.0 * focal_length / t3[:, 2]
    else:
        z0 = None
        s = 1.0 / mat[:, 3, 3]
    t2 = t3[:, :2] * s[:, None]
    quats = np.stack([matrix_to_quaternion(m)
                      for m in m_inv.detach().cpu().double().numpy()])
    return z0, t2, s, torch.as_tensor(quats, dtype=mat.dtype,
                                      device=mat.device)


def matrix_to_conditioning_vector(cam2world: torch.Tensor,
                                  focal_length: Optional[torch.Tensor],
                                  camera_flipped: bool) -> torch.Tensor:
    """The discriminator's 13-D pose conditioning (B, 13): log f (unshifted,
    the reference's convention; 0 without a focal), t2, s and the
    flattened world2cam rotation."""
    mat = _flip(cam2world) if camera_flipped else cam2world
    m_inv = invert_space(mat)
    rot = m_inv[:, :3, :3].reshape(mat.shape[0], 9)
    t3 = -m_inv[:, :3, 3]
    if focal_length is not None:
        z0 = torch.log(focal_length)
        s = 2.0 * focal_length / t3[:, 2]
    else:
        s = 1.0 / mat[:, 3, 3]
        z0 = torch.zeros_like(s)
    t2 = t3[:, :2] * s[:, None]
    return torch.cat((z0[:, None], t2, s[:, None], rot), dim=-1)


def rotation_matrix_distance(p: torch.Tensor,
                             q: torch.Tensor) -> torch.Tensor:
    """Geodesic distance in degrees between rotations (3x3 or scaled
    4x4)."""
    if p.shape[-1] == 4:
        p = p[..., :3, :3] / p[..., 3:4, 3:4]
        q = q[..., :3, :3] / q[..., 3:4, 3:4]
    pqt = torch.matmul(p, q.transpose(-2, -1))
    trace = pqt[..., 0, 0] + pqt[..., 1, 1] + pqt[..., 2, 2]
    cos_d = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    return torch.arccos(cos_d) / np.pi * 180.0


# Rows of the pose distance matrix computed at once by `perturb_poses`.
PERTURB_CHUNK = 1024


def perturb_poses(cam2world: np.ndarray, avg_angle: float, *extra_args,
                  seed: int = 1234):
    """Replaces each pose by the pose of the set whose rotation lies
    closest to U(0, 2 * avg_angle) degrees from it (host numpy, seeded):
    the distribution of poses is kept, each one moved to a neighbour.
    Returns (cam2world, *extra_args), each indexed the same way (None
    stays None)."""
    chunk = PERTURB_CHUNK
    rng = np.random.RandomState(seed)
    mats = np.asarray(cam2world)
    all_mats = torch.from_numpy(np.ascontiguousarray(mats))[None]
    indices = []
    for start in range(0, mats.shape[0], chunk):
        rows = torch.from_numpy(np.ascontiguousarray(
            mats[start:start + chunk]))[:, None]
        for row in rotation_matrix_distance(rows, all_mats).numpy():
            target = rng.rand() * avg_angle * 2.0
            indices.append(int(np.abs(row - target).argmin()))
    indices = np.asarray(indices)
    return (mats[indices].copy(),
            *[None if a is None else np.asarray(a)[indices].copy()
              for a in extra_args])
