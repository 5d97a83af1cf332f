"""viz/replay.py coverage (round-2 VERDICT item 4): the stdlib URDF
loader, joint-chain pose composition, and the dependency-free fallbacks
of `replay_trajectory` / `replay_urdf` (this environment has no `rerun`,
so the fallback branch is exactly what executes)."""

import json

import numpy as np

import jax.numpy as jnp

from trajectory_optimization_matrix_lie_groups.ops import se3
from trajectory_optimization_matrix_lie_groups.viz.replay import (
    _rpy_matrix,
    load_urdf,
    replay_trajectory,
    replay_urdf,
)

URDF = """<?xml version="1.0"?>
<robot name="testbot">
  <link name="base">
    <visual>
      <origin xyz="0.1 0 0" rpy="0 0 0"/>
      <geometry><box size="0.2 0.3 0.4"/></geometry>
    </visual>
  </link>
  <link name="arm">
    <visual>
      <geometry><cylinder radius="0.05" length="1.0"/></geometry>
    </visual>
  </link>
  <link name="tip">
    <visual>
      <geometry><sphere radius="0.1"/></geometry>
    </visual>
    <visual>
      <geometry>
        <mesh filename="package://meshes/ball.obj" scale="2 2 2"/>
      </geometry>
    </visual>
  </link>
  <joint name="j1" type="fixed">
    <parent link="base"/>
    <child link="arm"/>
    <origin xyz="1 0 0" rpy="0 0 1.5707963267948966"/>
  </joint>
  <joint name="j2" type="fixed">
    <parent link="arm"/>
    <child link="tip"/>
    <origin xyz="2 0 0"/>
  </joint>
</robot>
"""


def _write_urdf(tmp_path):
    p = tmp_path / "testbot.urdf"
    p.write_text(URDF)
    return str(p)


def test_load_urdf_geometries(tmp_path):
    model = load_urdf(_write_urdf(tmp_path))
    assert model["name"] == "testbot"
    base = model["links"]["base"]
    assert base[0]["geometry"] == dict(type="box", size=[0.2, 0.3, 0.4])
    np.testing.assert_allclose(base[0]["origin_xyz"], [0.1, 0, 0])
    arm = model["links"]["arm"][0]["geometry"]
    assert arm == dict(type="cylinder", radius=0.05, length=1.0)
    tip = model["links"]["tip"]
    assert tip[0]["geometry"] == dict(type="sphere", radius=0.1)
    mesh = tip[1]["geometry"]
    assert mesh["type"] == "mesh"
    # package:// stripped, resolved relative to the URDF's directory
    assert mesh["filename"].endswith("meshes/ball.obj")
    assert mesh["filename"].startswith(str(tmp_path))
    assert mesh["scale"] == [2.0, 2.0, 2.0]
    assert [j["name"] for j in model["joints"]] == ["j1", "j2"]


def test_urdf_joint_chain_pose_composition(tmp_path):
    """link_T composes through the chain: tip = base ∘ j1 ∘ j2 — checked
    against hand-computed transforms (Rz(90°) then a +x offset)."""
    model = load_urdf(_write_urdf(tmp_path))
    R_base, p_base = model["link_T"]["base"]
    np.testing.assert_allclose(R_base, np.eye(3))
    np.testing.assert_allclose(p_base, 0.0)

    Rz90 = _rpy_matrix([0, 0, np.pi / 2])
    R_arm, p_arm = model["link_T"]["arm"]
    np.testing.assert_allclose(R_arm, Rz90, atol=1e-12)
    np.testing.assert_allclose(p_arm, [1, 0, 0], atol=1e-12)

    # tip: p = R_arm @ [2,0,0] + p_arm = [1, 2, 0]; R unchanged by j2
    R_tip, p_tip = model["link_T"]["tip"]
    np.testing.assert_allclose(R_tip, Rz90, atol=1e-12)
    np.testing.assert_allclose(p_tip, [1, 2, 0], atol=1e-12)


def test_rpy_matrix_convention():
    """URDF rpy is extrinsic x-y-z == Rz(y) Ry(p) Rx(r)."""
    r, p, y = 0.3, -0.2, 0.9
    from trajectory_optimization_matrix_lie_groups.ops import so3

    Rx = np.asarray(so3.exp(jnp.array([r, 0, 0])))
    Ry = np.asarray(so3.exp(jnp.array([0, p, 0])))
    Rz = np.asarray(so3.exp(jnp.array([0, 0, y])))
    np.testing.assert_allclose(_rpy_matrix([r, p, y]), Rz @ Ry @ Rx,
                               atol=1e-12)


def _traj(T=5):
    xi = jnp.asarray([0.0, 0.0, 0.5, 1.0, 0.0, 0.0])
    qs = jnp.stack([se3.exp(xi * (0.1 * t)) for t in range(T + 1)])
    return qs


def test_replay_trajectory_fallback(tmp_path):
    """Without rerun, replay_trajectory degrades to the quat-pos .npy
    export; the written file must round-trip to the input poses."""
    qs = _traj()
    out = tmp_path / "traj.npy"
    res = replay_trajectory(qs, dt=0.1, fallback_path=str(out))
    assert res == str(out)
    qp = np.load(out)
    assert qp.shape == (qs.shape[0], 7)
    # quaternions normalized; positions match the matrix trajectory
    np.testing.assert_allclose(np.linalg.norm(qp[:, :4], axis=-1), 1.0,
                               atol=1e-6)
    np.testing.assert_allclose(qp[:, 4:], np.asarray(qs)[:, :3, 3],
                               atol=1e-6)
    # no fallback path -> None, nothing written
    assert replay_trajectory(qs, dt=0.1) is None


def test_replay_urdf_scene_json_fallback(tmp_path):
    """Without rerun, replay_urdf writes <path>.scene.json (parsed model)
    + <path>.npy (quat-pos trajectory) for external viewers."""
    urdf = _write_urdf(tmp_path)
    qs = _traj()
    base = tmp_path / "scene"
    res = replay_urdf(urdf, qs, dt=0.1, fallback_path=str(base))
    assert res == str(base)
    scene = json.loads((tmp_path / "scene.scene.json").read_text())
    assert scene["name"] == "testbot"
    assert set(scene["links"]) == {"base", "arm", "tip"}
    assert scene["links"]["base"][0]["geometry"]["type"] == "box"
    np.testing.assert_allclose(scene["link_T"]["tip"]["p"], [1, 2, 0],
                               atol=1e-12)
    qp = np.load(tmp_path / "scene.npy")
    assert qp.shape == (qs.shape[0], 7)
    assert replay_urdf(urdf, qs, dt=0.1) is None


def test_replay_reference_drone_urdf():
    """The reference's own drone URDF parses and yields visuals."""
    model = load_urdf("/root/reference/visualization/rerun/drone.urdf")
    assert model["links"]
    n_vis = sum(len(v) for v in model["links"].values())
    assert n_vis >= 1
    for name in model["links"]:
        R, p = model["link_T"][name]
        assert np.all(np.isfinite(R)) and np.all(np.isfinite(p))
