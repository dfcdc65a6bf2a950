"""The kitchen physics step as one CUDA kernel (`csrc/kitchen_step.cu`).

It replaces no TPU kernel: `beso_tpu/envs/kitchen/env.py::kitchen_step` is
jnp code that XLA fuses. The port's eager step (`envs/kitchen/env.py::
_kitchen_step_eager`) issues some 360 small operations per control step,
and its numpy-indexed writes are host-to-device copies that wait for the
stream, so the card idles while the host issues them. The kernel computes
the same step, one thread per env, in one launch with no host-to-device
copy and nothing the host waits for.

`kitchen_step(state, action, params, tables, act_amp, control_dt,
bonus_thresh)` takes any objects with the fields of `KitchenState`
(`STATE`), of `KitchenParams` (`PARAMS`) and of the env's per-device tables
(`TABLES`), all CUDA tensors on one device, and returns the new state's
eight fields and the reward [B]. It raises ValueError for a tensor of the
wrong device, dtype or shape, or one that is not contiguous, and for
tensors that are not on CUDA: the plain version of the
step is the eager one, which `envs/kitchen/env.py::kitchen_step` takes for
CPU tensors. Its `launches` counter goes up by one per launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from beso_tpu_torch.ops import build

_F32, _BOOL, _I32, _I64 = torch.float32, torch.bool, torch.int32, torch.int64

# KitchenState's fields: (name, shape after the batch, dtype)
STATE = (("qpos", (30,), _F32), ("ee_pos", (3,), _F32), ("tasks_to_complete", (7,), _BOOL),
         ("completed", (7,), _BOOL), ("completion_order", (7,), _I32),
         ("kettle_grasped", (), _BOOL), ("done", (), _BOOL), ("steps", (), _I32))
# KitchenParams' fields, in its order (all f32)
PARAMS = (("pivots", (7, 3)), ("axes", (7, 3)), ("handle0", (7, 3)), ("bar_dirs", (7, 3)),
          ("bar_halflen", (7,)), ("rotary", (7,)), ("drive_eff", (7,)),
          ("interact_radius", ()), ("grasp_radius", ()), ("release_radius", ()),
          ("grip_close_thresh", ()), ("grip_open_thresh", ()), ("kettle_gain", ()),
          ("kettle_max_speed", ()), ("wall_y", ()), ("micro_lo", (3,)), ("micro_hi", (3,)))
# the env's tables, in the kernel's order
TABLES = (("goal_vec", (30,), _F32), ("task_masks", (7, 30), _F32),
          ("joint_lo", (9,), _F32), ("joint_hi", (9,), _F32),
          ("obj_lo", (21,), _F32), ("obj_hi", (21,), _F32),
          ("primary", (7,), _I64), ("secondary", (7,), _I64),
          ("secondary_ratio", (7,), _F32), ("fk_table", (8, 5), _F32),
          ("base_pos", (3,), _F32))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library()
    vp = ctypes.c_void_p
    lib.beso_kitchen_step.argtypes = [vp] * 5 + [ctypes.c_float] * 3 + [ctypes.c_int, vp]
    lib.beso_kitchen_step.restype = ctypes.c_int
    return lib


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def kitchen_step(state, action: torch.Tensor, params, tables, act_amp: float,
                 control_dt: float, bonus_thresh: float):
    """One control step of B envs in one launch (see the module docstring):
    (qpos, ee_pos, tasks_to_complete, completed, completion_order,
    kettle_grasped, done, steps, reward)."""
    dev = state.qpos.device
    B = state.qpos.shape[0]
    fields = [getattr(state, name) for name, _, _ in STATE]
    # the kernel loads scalars, so any tensor's own alignment does (align=1):
    # a row slice, as a shard's known starts are, is read where it lies
    for t, (name, shape, dtype) in zip(fields, STATE):
        build.check_tensor(t, name, (B, *shape), dtype, dev, align=1)
    build.check_tensor(action, "action", (B, 9), _F32, dev, align=1)
    consts = [getattr(params, name) for name, _ in PARAMS]
    for t, (name, shape) in zip(consts, PARAMS):
        build.check_tensor(t, f"params.{name}", shape, _F32, dev, align=1)
    tabs = [getattr(tables, name) for name, _, _ in TABLES]
    for t, (name, shape, dtype) in zip(tabs, TABLES):
        build.check_tensor(t, name, shape, dtype, dev, align=1)
    if dev.type != "cuda":
        raise ValueError(f"the kitchen step kernel runs on CUDA, got {dev}")
    out = [torch.empty_like(t) for t in fields] + [torch.empty(B, dtype=_F32, device=dev)]
    if B:
        rc = _library().beso_kitchen_step(
            _ptrs(consts), _ptrs(tabs), _ptrs(fields), action.data_ptr(), _ptrs(out),
            act_amp, control_dt, bonus_thresh, B, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError("kitchen_step launch failed: " + build.error_string(rc))
        kitchen_step.launches += 1
    return tuple(out)


kitchen_step.launches = 0
