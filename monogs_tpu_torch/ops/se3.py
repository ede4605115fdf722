"""SE(3) / SO(3) Lie-group math on torch tensors.

Counterpart of ``monogs_tpu/ops/se3.py``: SO3 exp with the small-angle
series, the left Jacobian ``V``, SE3 exp with tau = [rho(3), theta(3)]
(translation first) and the left-multiplicative retraction
T <- Exp(tau) @ T. No in-place ops, so forward- and reverse-mode autograd
(``torch.func.jvp``, ``torch.autograd.grad``) run through every function.
"""

from __future__ import annotations

import torch

_SMALL = 1e-5
# floor under the squared angle, so that the sqrt and quotient rules of the
# branch torch.where does not take stay finite at theta = 0
_TINY = 1e-12


def skew(v):
    """3-vector -> 3x3 skew-symmetric matrix (batched over leading dims)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def _sin_over_x(x2):
    x = torch.sqrt(torch.clamp(x2, min=_TINY))
    small = 1.0 - x2 / 6.0
    return torch.where(x2 < _SMALL * _SMALL, small, torch.sin(x) / x)


def _one_minus_cos_over_x2(x2):
    x = torch.sqrt(torch.clamp(x2, min=_TINY))
    small = 0.5 - x2 / 24.0
    return torch.where(x2 < _SMALL * _SMALL, small,
                       (1.0 - torch.cos(x)) / torch.clamp(x2, min=_TINY))


def _x_minus_sin_over_x3(x2):
    x = torch.sqrt(torch.clamp(x2, min=_TINY))
    small = 1.0 / 6.0 - x2 / 120.0
    x3 = torch.clamp(x2, min=_TINY) * x
    return torch.where(x2 < _SMALL * _SMALL, small, (x - torch.sin(x)) / x3)


def _angle2(theta):
    """|theta|^2 as (..., 1, 1). Never 0-d: torch.func.jvp promotes the
    tangent of a 0-d tensor times a Python scalar to float64."""
    return torch.sum(theta * theta, dim=-1, keepdim=True)[..., None]


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape[:-1] + (3, 3))


def so3_exp(theta):
    """Rodrigues' formula. theta: (..., 3) -> (..., 3, 3)."""
    angle2 = _angle2(theta)
    W = skew(theta)
    W2 = W @ W
    a = _sin_over_x(angle2)
    b = _one_minus_cos_over_x2(angle2)
    return _eye3(theta) + a * W + b * W2


def so3_left_jacobian(theta):
    """V(theta): integrates translation under rotation."""
    angle2 = _angle2(theta)
    W = skew(theta)
    W2 = W @ W
    b = _one_minus_cos_over_x2(angle2)
    c = _x_minus_sin_over_x3(angle2)
    return _eye3(theta) + b * W + c * W2


def _rigid(R, t):
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # the (0, 0, 0, 1) row from t, so that no host-to-device copy (and no
    # stream synchronisation) happens per call
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])],
                       dim=-1)[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def se3_exp(tau):
    """tau = [rho(3), theta(3)] -> 4x4 transform."""
    rho = tau[..., :3]
    theta = tau[..., 3:]
    R = so3_exp(theta)
    t = (so3_left_jacobian(theta) @ rho[..., :, None])[..., 0]
    return _rigid(R, t)


def se3_inverse(T):
    """Inverse of a rigid transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t_inv = -(Rt @ T[..., :3, 3:4])[..., 0]
    return _rigid(Rt, t_inv)


def retract(T, tau):
    """Left-multiplicative retraction: Exp(tau) @ T."""
    return se3_exp(tau) @ T


def quat_to_rotmat(q):
    """Unnormalized quaternion (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                         2 * (x * z + r * y)], dim=-1),
            torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - r * x)], dim=-1),
            torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def pose_diff(P1, P2):
    """(translation distance, rotation angle) between two 4x4 poses."""
    trans = torch.linalg.norm(P1[:3, 3] - P2[:3, 3])
    dR = P1[:3, :3] @ P2[:3, :3].T
    cos_theta = torch.clamp((torch.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    return trans, torch.arccos(cos_theta)


def relative_pose_error(P1_gt, P2_gt, P1, P2):
    """(translation distance, rotation angle) between the relative motions
    P1_gt^-1 P2_gt and P1^-1 P2 of two frame pairs."""
    return pose_diff(se3_inverse(P1_gt) @ P2_gt, se3_inverse(P1) @ P2)
