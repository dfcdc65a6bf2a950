"""The port's native windowed-trajectory loader against `beso_tpu`'s (the
counterpart of `tests/test_native_loader.py`): the same slice table, and
for a (seed, batch id) the same batch bit for bit, in every goal mode, for
any thread count and through the prefetch ring; the library built into
`build/native/` by concurrent builds."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from beso_tpu.data.native import NativeSlicedLoader as JLoader
from beso_tpu_torch.data import native
from beso_tpu_torch.data.native import NativeSlicedLoader
from beso_tpu_torch.data.slicer import make_slices
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data

MODES = {"range": dict(min_future_sep=1), "tail": dict(only_sample_tail=True),
         "seq_end": dict(only_sample_seq_end=True), "no_goal": dict(future_conditional=False)}


@pytest.fixture(scope="module")
def data():
    return synthetic_kitchen_data(n_traj=6, t_max=40, seed=3)


def _args(data):
    return np.asarray(data.observations), np.asarray(data.actions), np.asarray(data.lengths)


def _kw(mode):
    kw = dict(window=4, future_conditional=True, future_seq_len=2, n_threads=2)
    kw.update(MODES[mode])
    if not kw["future_conditional"]:
        kw["future_seq_len"] = None
    return kw


@pytest.mark.parametrize("mode", list(MODES))
def test_batches_equal_jax_loader(data, mode):
    port, jax_loader = NativeSlicedLoader(*_args(data), **_kw(mode)), JLoader(*_args(data),
                                                                                **_kw(mode))
    np.testing.assert_array_equal(port.slices, jax_loader.slices)
    np.testing.assert_array_equal(port.slices, make_slices(data.lengths, 4))
    for seed, batch_id in ((7, 0), (1, 5), (9, 3)):
        got = port.sample_batch_host(seed, batch_id, 32)
        want = jax_loader.sample_batch_host(seed, batch_id, 32)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), v)


def test_deterministic_over_threads_and_batch_ids(data):
    a = NativeSlicedLoader(*_args(data), **_kw("range"))
    b = NativeSlicedLoader(*_args(data), **{**_kw("range"), "n_threads": 1})
    x, y = a.sample_batch_host(9, 3, 16), b.sample_batch_host(9, 3, 16)
    assert all(x[k].equal(y[k]) for k in x)
    assert not x["observation"].equal(a.sample_batch_host(9, 4, 16)["observation"])


def test_prefetch_stream_equals_direct_batches(data):
    nl = NativeSlicedLoader(*_args(data), **_kw("range"))
    stream = list(nl.batches(seed=11, batch_size=8, n_batches=5, n_buffers=2, device="cpu"))
    for k, batch in enumerate(stream):
        direct = nl.sample_batch_host(11, k, 8)
        assert all(batch[n].equal(direct[n]) and batch[n].device.type == "cpu" for n in direct)
    assert stream[0]["observation"].data_ptr() != stream[2]["observation"].data_ptr()


def test_no_window_fits_raises(data):
    with pytest.raises(ValueError, match="no trajectory is at least window=99"):
        NativeSlicedLoader(*_args(data), window=99, future_seq_len=2)


def test_concurrent_builds_leave_one_library(tmp_path):
    """Four processes building into an empty directory at once all load a
    whole library, and no temporary file is left."""
    code = ("import sys; from pathlib import Path; import beso_tpu_torch.data.native as n; "
            "n._BUILD_DIR = Path(sys.argv[1]); n._lib(); print('ok')")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert outs == ["ok"] * 4
    assert [p.name for p in tmp_path.iterdir()] == [native._build_lib().name]
