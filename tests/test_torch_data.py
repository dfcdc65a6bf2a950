"""The port's dataset loaders and writers (`beso_tpu_torch/data/trajectories.py`,
`data/export.py`) against `beso_tpu`'s: the synthetic block-push draw, the
relay-kitchen and multimodal-push file layouts read and written in both
directions, array for array, and the kitchen workspace's `data_path`.

The real datasets are not in the repo: every file here is written by one of
the two packages' `export_*` functions into a temporary directory.
"""

import numpy as np
import pytest
import torch

from beso_tpu.data import export as jexport
from beso_tpu.data import trajectories as jtraj
from beso_tpu_torch.data import export as texport
from beso_tpu_torch.data import trajectories as ttraj
from beso_tpu_torch.workspaces import FrankaKitchenWorkspace

FIELDS = ("observations", "actions", "lengths", "onehot_goals")


def _assert_same(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_push_data_equals_beso_tpu(seed):
    _assert_same(ttraj.synthetic_push_data(n_traj=12, t_max=40, seed=seed),
                 jtraj.synthetic_push_data(n_traj=12, t_max=40, seed=seed))


# (dataset, port writer, port loader, beso_tpu writer, beso_tpu loader, draw)
DATASETS = {
    "relay_kitchen": (texport.export_relay_kitchen, ttraj.load_relay_kitchen,
                      jexport.export_relay_kitchen, jtraj.load_relay_kitchen,
                      lambda: ttraj.synthetic_kitchen_data(n_traj=6, t_max=30, seed=3)),
    "multimodal_push": (texport.export_multimodal_push, ttraj.load_multimodal_push,
                        jexport.export_multimodal_push, jtraj.load_multimodal_push,
                        lambda: ttraj.synthetic_push_data(n_traj=6, t_max=30, seed=4)),
}


@pytest.mark.parametrize("direction", ["port_to_beso_tpu", "beso_tpu_to_port"])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_export_load_round_trip_across_packages(dataset, direction, tmp_path):
    """Files written by one package's export are read by the other's loader
    into the same arrays; each package also reads back its own files."""
    t_write, t_load, j_write, j_load, draw = DATASETS[dataset]
    data = draw()
    jdata = jtraj.TrajectoryData(*(getattr(data, f) for f in FIELDS))
    if direction == "port_to_beso_tpu":
        t_write(data, tmp_path)
        _assert_same(j_load(tmp_path), jdata)
        _assert_same(t_load(tmp_path), data)
    else:
        j_write(jdata, tmp_path)
        _assert_same(t_load(tmp_path), data)
        _assert_same(j_load(tmp_path), jdata)


def test_push_loader_reduces_obs_dim(tmp_path):
    data = ttraj.synthetic_push_data(n_traj=4, t_max=20, seed=1)
    texport.export_multimodal_push(data, tmp_path)
    got = ttraj.load_multimodal_push(tmp_path, onehot_goals=False, reduce_obs_dim=True)
    want = jtraj.load_multimodal_push(tmp_path, onehot_goals=False, reduce_obs_dim=True)
    assert got.onehot_goals is None and want.onehot_goals is None
    np.testing.assert_array_equal(got.observations, want.observations)
    assert got.observations.shape == (4, 20, 10)


def test_kitchen_workspace_data_path_matches_data(tmp_path):
    """`data_path` loads the relay-kitchen files as `beso_tpu`'s workspace
    does; the split and the scaler equal those of `data=` with the same
    trajectories."""
    data = ttraj.synthetic_kitchen_data(n_traj=20, t_max=40, seed=9)
    texport.export_relay_kitchen(data, tmp_path)
    kw = dict(seed=42, window_size=4, goal_seq_len=2, scale_data=True, device="cpu")
    from_path = FrankaKitchenWorkspace(data_path=str(tmp_path), **kw)
    from_data = FrankaKitchenWorkspace(data=data, **kw)
    _assert_same(from_path.full_data, data)
    for split in ("train_set", "test_set"):
        a, b = getattr(from_path, split), getattr(from_data, split)
        for name in ("slices", "observations", "actions", "lengths"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (split, name)
    for name in ("x_mean", "x_std", "y_mean", "y_std", "x_bounds", "y_bounds"):
        assert torch.equal(getattr(from_path.scaler, name), getattr(from_data.scaler, name))


def test_export_needs_onehot_goals(tmp_path):
    data = ttraj.synthetic_kitchen_data(n_traj=2, t_max=10)
    with pytest.raises(ValueError, match="one-hot goals"):
        texport.export_relay_kitchen(ttraj.TrajectoryData(data.observations, data.actions,
                                                          data.lengths), tmp_path)
