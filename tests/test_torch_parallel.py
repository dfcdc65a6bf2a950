"""`beso_tpu_torch.parallel` against `beso_tpu.parallel`: the mesh API, the
tensor-parallel rules, the dp, dcn x dp and dp x tp train steps, the seed
sweep over "dp" and the dry run.

The port's multi-device steps run on 4 gloo CPU ranks spawned once for
the module (`torch_dist_workers.train_worker`); JAX's run on the 8-device
virtual CPU mesh of conftest.py. The JAX cases inject JAX's global sigma
and noise into the port's ranks (the model draws nothing else there); the
port-only cases draw everything, dropout and the CFG goal mask included,
from one generator on every rank and are held against one process on the
same generator. Loss to 1e-5 relative; parameters after one AdamW step
within 1e-5, the key third of each qkv bias apart (a zero gradient in
exact arithmetic, which Adam turns into steps of up to lr: ROADMAP C2).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_dist_workers as workers
from torch_parity import make_models, t

import beso_tpu.train.trainer as jtr
import beso_tpu_torch.train.trainer as ttr
from beso_tpu.core.densities import make_sample_density as j_density
from beso_tpu.data import SlicedDataset as JSlicedDataset
from beso_tpu.models.ema import ema_init as j_ema_init
from beso_tpu.models.scaler import fit_scaler as j_fit_scaler
from beso_tpu.parallel import make_mesh as j_make_mesh
from beso_tpu.parallel import make_multislice_mesh as j_make_multislice
from beso_tpu.parallel import partition_batch as j_partition_batch
from beso_tpu.parallel import partition_params as j_partition_params
from beso_tpu.parallel import replicate as j_replicate
from beso_tpu.parallel import tp_param_spec as j_tp_param_spec
from beso_tpu_torch.core.densities import make_sample_density
from beso_tpu_torch.data.slicer import SlicedDataset
from beso_tpu_torch.data.trajectories import synthetic_kitchen_data
from beso_tpu_torch.models.convert import model_entries, params_to_numpy_tree
from beso_tpu_torch.models.denoiser import GCDenoiser
from beso_tpu_torch.models.ema import ema_init
from beso_tpu_torch.models.gpt import DiffusionGPT
from beso_tpu_torch.models.scaler import fit_scaler
from beso_tpu_torch.parallel import (data_axes, gather_full, init_distributed, make_mesh,
                                     make_multislice_mesh, partition_batch, replicate,
                                     tp_param_spec)
from beso_tpu_torch.parallel.launch import free_port, spawn
from beso_tpu_torch.train.sweep import (init_sweep_state, make_sweep_train_steps,
                                        seed_generators)

LR, B = 1e-4, 16
KW = dict(n_heads=4)   # 48 wide, 4 heads of 12: tp=2 leaves 2 heads per rank
JAX_CASES = {"dp4": ("dp", 4, 1), "dcn2x2": ("dcn", 2, 1), "dp2xtp2": ("dp", 4, 2)}
# the port's own draws: dropout everywhere and the CFG goal mask; 65 tokens
# take the flash path (plain versions on the CPU), whose heads tp splits
DRAW_KW = dict(cond_mask_prob=0.1, attn_pdrop=0.3, resid_pdrop=0.1, embed_pdrob=0.1)
DRAW_CASES = {"draws_dp4": ("dp", 4, 1, DRAW_KW, 4), "draws_dp2xtp2": ("dp", 4, 2, DRAW_KW, 4),
              "flash_dp2xtp2": ("dp", 4, 2, dict(cond_mask_prob=0.1), 31)}
SWEEP_SEEDS, SWEEP_STEPS, SWEEP_BATCH = (1, 2, 3, 4), 2, 8


def _flat(tree) -> dict:
    """Flax-named leaves; the key third of every qkv bias as a leaf of its own."""
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if name.endswith("['qkv']['bias']"):
            q, k, v = np.split(a, 3)
            out[name], out[name + "#key"] = np.concatenate([q, v]), k
        else:
            out[name] = a
    return out


def assert_params_close(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        tol = 3 * LR if name.endswith("#key") else 1e-5
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol, err_msg=f"{what} {name}")


def _kitchen(window):
    data = synthetic_kitchen_data(n_traj=6, t_max=max(40, window + 10), seed=3)
    return data, fit_scaler(data.all_observations(), data.all_actions(), scale_data=True)


@pytest.fixture(scope="module")
def setup():
    """The JAX model and its global draws, the port's spec, the spawned
    ranks' results, and one process's steps on the same inputs."""
    kw, jden, params, tden = make_models(seed=51, **KW)
    data, tscaler = _kitchen(4)
    jscaler = j_fit_scaler(data.all_observations(), data.all_actions(), scale_data=True)
    jds = JSlicedDataset(data, window=4, future_seq_len=2, future_conditional=True)
    batch = {k: np.asarray(v) for k, v in jds.sample_batch(jax.random.PRNGKey(0), B).items()}
    jdensity = j_density("loglogistic", 0.5, 0.005, 1.0)
    key = jax.random.PRNGKey(2)
    k_sig, k_noise, _ = jax.random.split(key, 3)
    sigma = np.asarray(jdensity(k_sig, (B,)))
    noise = np.asarray(jax.random.normal(k_noise, batch["action"].shape))
    state = tden.inner_model.state_dict()
    cases = {name: dict(mesh=m, model_kw=kw, state=state, opt="adamw", lr=LR, batch=batch,
                        scaler=tscaler, sigma=sigma, noise=noise)
             for name, m in JAX_CASES.items()}
    port_single = {}
    for name, (*m, extra, window) in DRAW_CASES.items():
        dkw = {**kw, **extra, "obs_seq_len": window}
        model = DiffusionGPT(**dkw, generator=torch.Generator().manual_seed(7))
        ddata, dscaler = _kitchen(window)
        dbatch = SlicedDataset(ddata, window=window, future_seq_len=2, device="cpu").sample_batch(
            torch.Generator().manual_seed(8), B)
        dbatch = {k: v.numpy() for k, v in dbatch.items()}
        cases[name] = dict(mesh=tuple(m), model_kw=dkw, state=model.state_dict(), opt="adamw",
                           lr=LR, batch=dbatch, scaler=dscaler, seed=9)
        port_single[name] = _single_step(cases[name])
    sweep = dict(mesh=("dp", 4, 2), model_kw=kw, seeds=SWEEP_SEEDS, data=data, scaler=tscaler,
                 batch=SWEEP_BATCH, steps=SWEEP_STEPS)
    return dict(kw=kw, jden=jden, params=params, tden=tden, jscaler=jscaler, batch=batch,
                jdensity=jdensity, key=key, cases=cases, sweep=sweep, port_single=port_single)


def _single_step(case, monkeypatch=None):
    """One process's `make_train_step` on the case's weights and draws."""
    model = DiffusionGPT(**case["model_kw"])
    model.load_state_dict(case["state"])
    opt, sched = ttr.make_optimizer(model.parameters(), case["opt"], case["lr"])
    ts = ttr.TrainState(model, opt, sched, ema_init(model.named_parameters()))
    batch = {k: t(v) for k, v in case["batch"].items()}
    if "sigma" in case:
        monkeypatch.setattr(ttr, "step_noise", lambda *a: t(case["noise"]))
        loss = ttr.make_train_step(GCDenoiser(model, 0.5), lambda *a, **k: t(case["sigma"]),
                                   case["scaler"])(ts, batch, None)
    else:
        loss = ttr.make_train_step(GCDenoiser(model, 0.5),
                                   make_sample_density("loglogistic", 0.5, 0.005, 1.0),
                                   case["scaler"])(ts, batch, torch.Generator().manual_seed(
                                       case["seed"]))
    named = dict(model.named_parameters())
    return dict(loss=float(loss), params={n: p.detach() for n, p in named.items()},
                grads={n: p.grad for n, p in named.items()}, ema=ts.ema.params, model=model)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    path = tmp_path_factory.mktemp("train_ranks")
    torch.save(dict(cases=setup["cases"], sweep=setup["sweep"]), path / "spec.pt")
    spawn(workers.train_worker, 4, "gloo", args=(str(path),), timeout_s=240)
    out = {name: torch.load(path / f"{name}.pt") for name in setup["cases"]}
    out["sweep"] = [torch.load(path / f"sweep_rank{r}.pt") for r in range(4)]
    return out


def _jax_step(setup, name):
    """JAX's `make_train_step` on the case's mesh (4 of the 8 virtual devices)."""
    jden, params, batch = setup["jden"], setup["params"], setup["batch"]
    opt = jtr.make_optimizer("adamw", LR)
    step = jtr.make_train_step(jden, opt, setup["jdensity"], setup["jscaler"])
    kind, n, tp = JAX_CASES[name]
    devices = jax.devices()[:4]
    mesh = (j_make_mesh(n, tp=tp, devices=devices) if kind == "dp"
            else j_make_multislice(n, tp=tp, devices=devices))
    with mesh:
        p = j_partition_params(params, mesh) if tp > 1 else j_replicate(params, mesh)
        ts = jtr.TrainState(p, j_replicate(opt.init(params), mesh), j_ema_init(p),
                            jnp.zeros((), jnp.int32))
        ts, loss = step(ts, j_partition_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                              mesh), setup["key"])
    return float(loss), jax.tree.map(np.asarray, ts.params)


def test_tp_param_spec_maps_jax_rules():
    """The port's spec is JAX's `_TP_RULES` on the same model, over torch's
    [out, in] dims: JAX's P(None, "tp") on a [in, out] kernel is ("tp", None)."""
    _, _, params, tden = make_models(seed=1, **KW)
    model = tden.inner_model
    jspec = {jax.tree_util.keystr(p): s for p, s in
             jax.tree_util.tree_flatten_with_path(
                 j_tp_param_spec(params), is_leaf=lambda x: isinstance(x, jax.sharding.
                                                                        PartitionSpec))[0]}
    names = {id(p): n for n, p in model.named_parameters()}
    spec = tp_param_spec(model)
    n_sharded = 0
    for path, mod, kind in model_entries(model):
        if kind != "dense":
            continue
        prefix = "['params']" + "".join(f"['{p}']" for p in path)
        kernel, bias = jspec[prefix + "['kernel']"], jspec[prefix + "['bias']"]
        assert spec[names[id(mod.weight)]] == (tuple(reversed(tuple(kernel)))
                                               if len(kernel) else ()), path
        assert spec[names[id(mod.bias)]] == tuple(bias), path
        n_sharded += len(kernel) > 0
    assert n_sharded == 4 * model.n_layers   # qkv, proj, fc, fc_proj per block


@pytest.fixture
def one_rank():
    init_distributed("gloo", 0, 1, f"tcp://127.0.0.1:{free_port()}", 60)
    yield
    dist.destroy_process_group()


def test_mesh_api_on_one_rank(one_rank):
    mesh = make_mesh(1, tp=1, backend="gloo")
    assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.shape) == (1, 1)
    assert data_axes(mesh) == ("dp",)
    ms = make_multislice_mesh(1, tp=1, backend="gloo")
    assert ms.mesh_dim_names == ("dcn", "dp", "tp") and data_axes(ms) == ("dcn", "dp")
    with pytest.raises(RuntimeError, match="not the mesh's 'nccl'"):
        make_mesh(1, backend="nccl")
    with pytest.raises(ValueError, match="not divisible by tp"):
        make_mesh(1, tp=2, backend="gloo")
    x = torch.arange(6.0)
    assert partition_batch({"a": x}, mesh)["a"].equal(x)
    assert replicate(x, mesh) is x
    assert gather_full({"blocks.0.fc.weight": x}, mesh)["blocks.0.fc.weight"].equal(x)


def test_nccl_without_a_card_raises():
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        init_distributed("nccl", 0, 1, f"tcp://127.0.0.1:{free_port()}", 10)
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        init_distributed("mpi", 0, 1, "tcp://127.0.0.1:1", 10)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_step_matches_jax_and_one_process(name, setup, ranks, monkeypatch):
    """dp=4, 2 slices x dp=2 and dp=2 x tp=2 on JAX's global draws: the loss
    against JAX's sharded step and one port process (1e-5 relative), the
    parameters after the step against JAX's and the EMA shadow against one
    process's (1e-5), the gradients against one process's (1e-5 of each
    tensor's max)."""
    got = ranks[name]
    j_loss, j_params = _jax_step(setup, name)
    single = _single_step(setup["cases"][name], monkeypatch)
    np.testing.assert_allclose(got["loss"], j_loss, rtol=1e-5)
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5)
    model = setup["tden"].inner_model
    assert_params_close(_flat(params_to_numpy_tree(model, got["params"])), _flat(j_params),
                        name)
    assert_params_close(_flat(params_to_numpy_tree(model, got["ema"])),
                        _flat(params_to_numpy_tree(model, single["ema"])), name + " ema")
    for n, w in single["grads"].items():
        np.testing.assert_allclose(got["grads"][n].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()), err_msg=f"{name} grad {n}")


@pytest.mark.parametrize("name", list(DRAW_CASES))
def test_global_draws_match_one_process(name, setup, ranks):
    """Every rank draws sigma, noise, the goal mask and the dropouts over the
    global batch from one generator and takes its rows (the attention
    dropout's heads too under tp): loss, gradients and parameters equal one
    process's on that generator (1e-5)."""
    got, want = ranks[name], setup["port_single"][name]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    model = want["model"]
    assert_params_close(_flat(params_to_numpy_tree(model, got["params"])),
                        _flat(params_to_numpy_tree(model, want["params"])), name)
    for n, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()), err_msg=f"{name} {n}")


def test_shard_sweep_state_matches_the_unsharded_sweep(setup, ranks):
    """4 seeds over dp=2 (x tp=2): each rank trains 2 seeds on their own
    generators with no communication; each seed's losses and parameters
    equal the 1-rank 4-seed sweep's (1e-6 / 1e-6)."""
    sw = setup["sweep"]
    ss = init_sweep_state(lambda g: DiffusionGPT(**sw["model_kw"], generator=g),
                          partial(ttr.make_optimizer, name="adamw", lr=1e-4), sw["seeds"])
    ds = SlicedDataset(sw["data"], window=4, future_seq_len=2, device="cpu")
    fused = make_sweep_train_steps(make_sample_density("loglogistic", 0.5, 0.005, 1.0),
                                   sw["scaler"], ds, sw["batch"], sw["steps"])
    _, losses = fused(ss, seed_generators(ss.seeds, "cpu")[0])
    seen = set()
    for r, part in enumerate(ranks["sweep"]):
        dp = r // 2   # (dp, tp) coordinates of rank r in a 2 x 2 mesh
        assert part["seeds"] == sw["seeds"][2 * dp:2 * dp + 2]
        for j, seed in enumerate(part["seeds"]):
            i = sw["seeds"].index(seed)
            seen.add(seed)
            np.testing.assert_allclose(part["losses"][j].numpy(), losses[i].numpy(), rtol=1e-6)
            for k, v in ss.params.items():
                np.testing.assert_allclose(part["params"][k][j].numpy(),
                                           v[i].detach().numpy(), rtol=0, atol=1e-6)
    assert seen == set(sw["seeds"])


def test_shard_sweep_state_refuses_an_uneven_split():
    class Mesh2:   # a "dp" axis of 2 seen from rank 0
        mesh_dim_names = ("dp",)

        def size(self, dim):
            return 2

        def get_local_rank(self, axis):
            return 0

    from beso_tpu_torch.train.sweep import shard_sweep_state

    ss = init_sweep_state(lambda g: DiffusionGPT(**make_models(seed=1)[0], generator=g),
                          partial(ttr.make_optimizer, name="adamw", lr=1e-4), (1, 2, 3))
    with pytest.raises(ValueError, match="3 seeds not divisible over 2"):
        shard_sweep_state(ss, Mesh2())


def test_dryrun_multigpu_four_ranks():
    """The dry run's dp=2 x tp=2 step, sharded fused rollout and 2-slice
    step on 4 spawned gloo ranks."""
    from beso_tpu_torch.parallel.dryrun import dryrun_multigpu

    dryrun_multigpu(4, timeout_s=240)


def test_spawn_raises_for_a_failed_and_a_hung_rank():
    with pytest.raises(RuntimeError, match=r"ranks \[1\] failed"):
        spawn(workers.fail_on_rank_1, 2, "gloo", timeout_s=60)
    with pytest.raises(TimeoutError, match="still running"):
        spawn(workers.hang, 1, "gloo", timeout_s=4)
