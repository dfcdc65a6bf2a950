"""Parity of the port's ray-cast cameras (`beso_tpu_torch/envs/block_push/
camera.py`, `beso_tpu_torch/envs/kitchen/camera.py`) with the JAX package's.

Images are compared by pixel share: the silhouette tests (the top-face
pick, the `mask > 0.5` depth update, the kitchen's hard occlusion) flip a
whole pixel where two depths differ by an ulp, so all but 0.5% of the
pixels must agree within 1e-5 in every channel, and the rest is counted
and printed. The fixed ray grids agree within 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

import beso_tpu.envs.block_push.camera as jcam
import beso_tpu.envs.kitchen.camera as jkcam
import beso_tpu_torch.envs.block_push.camera as tcam
import beso_tpu_torch.envs.kitchen.camera as tkcam
from beso_tpu.envs.block_push.env import block_push_obs, block_push_reset
from beso_tpu.envs.kitchen.env import INIT_QPOS

torch.set_num_threads(1)

PIXEL_TOL = 1e-5
PIXEL_SHARE = 0.005


def assert_pixel_share(got, ref, what=""):
    """All but PIXEL_SHARE of the pixels [N, h, w, C] within PIXEL_TOL in
    every channel; prints the count of the others."""
    bad = (np.abs(got - ref) > PIXEL_TOL).any(-1)
    print(f"{what}: {int(bad.sum())} of {bad.size} pixels off by > {PIXEL_TOL} "
          f"(max {np.abs(got - ref).max():.3g})")
    assert got.shape == ref.shape
    assert bad.mean() <= PIXEL_SHARE, f"{what}: {bad.mean():.4f} of the pixels differ"


def _block_push_obs(n=12, seed=0):
    """Reset observations with the effector beside block 0, one block moved
    to the image's edge and one turned 45 degrees."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    obs = np.array(jax.vmap(lambda k: block_push_obs(block_push_reset(k)))(keys))
    obs[:, 6:8] = obs[:, 0:2] + np.asarray([0.03, -0.04])
    obs[1, 3:5] = [0.62, 0.35]
    obs[2, 2] = np.pi / 4
    return obs.astype(np.float32)


@pytest.mark.parametrize("hw", [(32, 32), (64, 64)])
@pytest.mark.parametrize("zoom", [1.0, 2.0])
def test_block_push_grids_match_jax(hw, zoom):
    np.testing.assert_allclose(tcam.ray_grid(*hw, zoom), jcam.ray_grid(*hw, zoom), atol=1e-6)
    np.testing.assert_allclose(tcam.table_grid(*hw, zoom), jcam.table_grid(*hw, zoom),
                               atol=1e-6)


@pytest.mark.parametrize("hw", [(32, 32), (64, 64)])
@pytest.mark.parametrize("zoom", [1.0, 2.0])
@pytest.mark.parametrize("fn", ["render_obs_rgb", "render_obs_masks"])
def test_block_push_render_matches_jax(fn, zoom, hw):
    """RGB [N, h, w, 3] and masks [N, h, w, 5] of 12 frames against the
    vmapped JAX renderer, by pixel share."""
    obs = _block_push_obs()
    ref = np.asarray(jax.vmap(lambda o: getattr(jcam, fn)(o, *hw, zoom))(jnp.asarray(obs)))
    got = getattr(tcam, fn)(t(obs), *hw, zoom).numpy()
    assert_pixel_share(got, ref, f"{fn} {hw} zoom {zoom}")
    assert np.ptp(ref) > 0.3


def test_block_push_solid_parallax():
    """The blocks are 4 cm boxes, not tabletop decals: the block's
    silhouette covers pixels whose table point lies outside its footprint
    (the top face seen from the oblique camera), in both packages alike."""
    obs = _block_push_obs(4, seed=3)
    obs[:, 0:2] = [[0.45, 0.0], [0.3, 0.1], [0.55, -0.1], [0.4, 0.15]]   # in view
    obs[:, 6:8] = obs[:, 0:2] + np.asarray([0.03, -0.04])
    h = w = 64
    masks = tcam.render_obs_masks(t(obs), h, w).numpy()
    ref = np.asarray(jax.vmap(lambda o: jcam.render_obs_masks(o, h, w))(jnp.asarray(obs)))
    assert_pixel_share(masks, ref, "parallax masks")
    grid = tcam.table_grid(h, w, 2.0)
    for i in range(4):
        rel = grid - obs[i, 0:2]
        c, s = np.cos(obs[i, 2]), np.sin(obs[i, 2])
        lx, ly = rel[..., 0] * c + rel[..., 1] * s, -rel[..., 0] * s + rel[..., 1] * c
        footprint = (np.abs(lx) <= 0.02) & (np.abs(ly) <= 0.02)
        solid = masks[i, ..., 0] > 0.5
        assert solid.sum() > footprint.sum() > 0
        assert (solid & ~footprint).sum() > 0


def _kitchen_obs():
    """The start pose, the arm moved, and each articulated element moved in
    a frame of its own: burners, light, slide and hinge cabinets,
    microwave, kettle, fingers."""
    base = np.asarray(INIT_QPOS, np.float32)
    frames = [base.copy() for _ in range(10)]
    frames[1][:7] += [0.5, 0.4, 0.0, 0.5, 0.0, 0.3, 0.0]
    frames[2][11] = -0.9
    frames[3][15] = -0.9
    frames[4][17] = -0.7
    frames[5][19] = 0.35
    frames[6][21] = 1.4
    frames[7][22] = -0.75
    frames[8][23:26] += [-0.15, 0.1, 0.05]
    frames[9][7] = 0.04
    return np.stack(frames).astype(np.float32)


@pytest.mark.parametrize("hw", [(32, 32), (64, 64)])
def test_kitchen_grid_matches_jax(hw):
    np.testing.assert_allclose(tkcam.kitchen_ray_grid(*hw), jkcam.kitchen_ray_grid(*hw),
                               atol=1e-6)


@pytest.mark.parametrize("hw", [(32, 32), (64, 64)])
def test_kitchen_render_matches_jax(hw):
    """10 frames, each articulated element moved in one, against the vmapped
    JAX renderer by pixel share; at 64 px each moved element changes its
    frame (the light strip and the finger pads span a pixel or two)."""
    obs = _kitchen_obs()
    ref = np.asarray(jax.vmap(lambda o: jkcam.render_kitchen_obs_rgb(o, *hw))(
        jnp.asarray(obs)))
    got = tkcam.render_kitchen_obs_rgb(t(obs), *hw).numpy()
    assert_pixel_share(got, ref, f"kitchen {hw}")
    if hw == (64, 64):
        for i in range(1, 10):
            assert np.abs(got[i] - got[0]).max() > 0.03, f"frame {i} shows no change"
