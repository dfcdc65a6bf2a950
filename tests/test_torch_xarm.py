"""xArm6 FK/IK and the pose math of `beso_tpu_torch` against `beso_tpu`
(the counterpart of `tests/test_xarm.py`, itself the reference's
`xarm_sim_robot_test.py`): the golden FK values, FK and every pose
function on a batch against JAX's (1e-5), the IK round trip at the
reference test's thresholds and against JAX's IK (1e-3), scipy's rotations."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import beso_tpu.envs.block_push.xarm as jxarm
import beso_tpu.envs.pose3d as jpose
from beso_tpu_torch.envs.block_push.xarm import HOME_JOINTS, xarm_fk, xarm_fk_pose, xarm_ik
from beso_tpu_torch.envs.pose3d import (Pose3d, matrix_from_quat, quat_conj, quat_from_matrix,
                                        quat_from_rotvec, quat_mul, quat_to_rotvec,
                                        yaw_from_quat)

TOL = dict(atol=1e-5, rtol=1e-5)


def test_forward_kinematics_golden():
    """xarm_sim_robot_test.py:47-62: down the X axis, then the Y axis."""
    pos, _ = xarm_fk(torch.tensor([[0.0, math.pi / 2, math.pi, 0, 0, 0],
                                   [math.pi / 2, math.pi / 2, math.pi, 0, 0, 0]]))
    np.testing.assert_allclose(pos[0, :2].numpy(), [0.714479, -0.0006], atol=1e-3)
    np.testing.assert_allclose(pos[1, :2].numpy(), [0.0006, 0.714479], atol=1e-3)


def test_fk_matches_jax_on_a_batch():
    q = np.random.RandomState(0).uniform(-1, 1, (8, 6)).astype(np.float32)
    pos, R = xarm_fk(torch.as_tensor(q))
    jpos, jR = jax.vmap(jxarm.xarm_fk)(jnp.asarray(q))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), **TOL)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), **TOL)
    pose, jp = xarm_fk_pose(torch.as_tensor(q)), jax.vmap(jxarm.xarm_fk_pose)(jnp.asarray(q))
    np.testing.assert_allclose(pose.vec7.numpy(), np.asarray(jax.vmap(lambda p: p.vec7)(jp)),
                               **TOL)
    assert float(pos.norm(dim=1).max()) < 1.2   # reach bound


@pytest.mark.parametrize("in_inference_mode", [False, True])
def test_ik_round_trip_and_jax(in_inference_mode):
    """xarm_sim_robot_test.py:64-76: IK -> FK within 1e-2 and 0.05 rad; the
    pose error under 1e-3 and the joints within 1e-3 of JAX's IK. In
    inference mode too: the jacobian's jvp runs outside it (ROADMAP C2)."""
    rv, t = np.array([0.0, math.pi / 2, 0.0], np.float32), np.array([0.5, 0.0, 0.1], np.float32)
    target = Pose3d(rotation=quat_from_rotvec(torch.as_tensor(rv)), translation=torch.as_tensor(t))
    with torch.inference_mode(in_inference_mode):
        q = xarm_ik(target)
    pose = xarm_fk_pose(q)
    np.testing.assert_allclose(pose.translation.numpy(), t, atol=1e-3)
    angle = float(quat_to_rotvec(quat_mul(target.rotation, quat_conj(pose.rotation))).norm())
    assert angle < 1e-3
    jq = jxarm.xarm_ik(jpose.Pose3d(rotation=jpose.quat_from_rotvec(jnp.asarray(rv)),
                                    translation=jnp.asarray(t)), jxarm.HOME_JOINTS)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-3)
    assert tuple(HOME_JOINTS) == tuple(np.asarray(jxarm.HOME_JOINTS).tolist())


def test_ik_is_batched():
    rv = np.array([[0.0, math.pi / 2, 0.0], [0.0, math.pi / 2, 0.2]], np.float32)
    t = np.array([[0.5, 0.0, 0.1], [0.45, 0.1, 0.15]], np.float32)
    target = Pose3d(quat_from_rotvec(torch.as_tensor(rv)), torch.as_tensor(t))
    q = xarm_ik(target)
    assert q.shape == (2, 6)
    np.testing.assert_allclose(xarm_fk_pose(q).translation.numpy(), t, atol=1e-3)


def test_pose_functions_match_jax():
    rng = np.random.RandomState(1)
    rv = rng.uniform(-2, 2, (16, 3)).astype(np.float32)
    rv[0] = 0.0   # the zero-angle branch
    q = np.array(jax.vmap(jpose.quat_from_rotvec)(jnp.asarray(rv)))
    b = rng.randn(16, 4).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    tq, tb = torch.as_tensor(q), torch.as_tensor(b)
    for got, want in [
            (quat_from_rotvec(torch.as_tensor(rv)), q),
            (quat_to_rotvec(tq), jax.vmap(jpose.quat_to_rotvec)(jnp.asarray(q))),
            (quat_mul(tq, tb), jax.vmap(jpose.quat_mul)(jnp.asarray(q), jnp.asarray(b))),
            (quat_conj(tq), jax.vmap(jpose.quat_conj)(jnp.asarray(q))),
            (matrix_from_quat(tq), jax.vmap(jpose.matrix_from_quat)(jnp.asarray(q))),
            (quat_from_matrix(matrix_from_quat(tq)), jax.vmap(jpose.quat_from_matrix)(
                jax.vmap(jpose.matrix_from_quat)(jnp.asarray(q)))),
            (yaw_from_quat(tq), jax.vmap(jpose.yaw_from_quat)(jnp.asarray(q)))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pose3d_and_scipy():
    p = Pose3d(rotation=torch.tensor([0.0, 0.0, 0.0, 1.0]), translation=torch.tensor([1.0, 2, 3]))
    np.testing.assert_allclose(p.vec7.numpy(), [1, 2, 3, 0, 0, 0, 1])
    rv = np.asarray([0.2, 0.9, -0.4])
    q = quat_from_rotvec(torch.as_tensor(rv))
    np.testing.assert_allclose(q.numpy(), Rotation.from_rotvec(rv).as_quat(), atol=1e-6)
    np.testing.assert_allclose(matrix_from_quat(q).numpy(),
                               Rotation.from_rotvec(rv).as_matrix(), atol=1e-6)
    q2 = quat_from_matrix(matrix_from_quat(q))
    assert min(float((q - q2).norm()), float((q + q2).norm())) < 1e-5
    assert abs(float(yaw_from_quat(quat_from_rotvec(torch.tensor([0.0, 0.0, 1.1])))) - 1.1) < 1e-5
