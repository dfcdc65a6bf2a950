"""The reference-checkpoint model of `beso_tpu_torch` against `beso_tpu` (CPU,
f32): the erf GELU (`approximate_gelu=False`) in the model and in the plain
versions of the fused-layer kernels B1-B4 (held against the Pallas kernels
in interpret mode) and the engines, the sigma-embedding kinds, the MLP
networks, and the reference `.pth` key space both ways (JAX export -> port
load, port export -> JAX convert), with the goal embedding the JAX
converter drops. Tolerances are those of the tanh forms in
`test_torch_gpt.py` and `test_torch_fused_engines.py`: atol = rtol = 1e-5,
engines rtol 1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (E, TOL, _redraw, from_tl, jax_layer, layer_weights, make_inputs,
                          make_models, port_layer, prefix_tdb, prefix_tl, t, to_tdb)

import beso_tpu.models.fused as jfused
from beso_tpu.models import embeddings as jemb
from beso_tpu.models import mlps as jmlps
from beso_tpu.ops import fused_layer as jfl
from beso_tpu.train import checkpoint as jck
from beso_tpu_torch.models import embeddings as temb
from beso_tpu_torch.models import make_fused_denoise_fn
from beso_tpu_torch.models import mlps as tmlps
from beso_tpu_torch.models.cached import extract_gpt_params, make_cached_denoise_fn
from beso_tpu_torch.models.convert import (embedding_entries, entries_from_jax, mlp_entries,
                                           params_to_numpy_tree)
from beso_tpu_torch.models.fused import make_fused_cached_denoise_fn, prepare_fused_gpt
from beso_tpu_torch.models.gpt import DiffusionGPT, gelu
from beso_tpu_torch.ops import fused_layer as fl
from beso_tpu_torch.train import checkpoint as tck

ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)
ERF = dict(approximate_gelu=False)
GRID = np.asarray([1.0, 0.3, 0.05], np.float32)


def _jax_forward(jden, params, inputs, **kw):
    return np.asarray(jden.inner_model.apply(params, *(jnp.asarray(v) for v in inputs), **kw))


# ---- the model ---------------------------------------------------------------

def test_gelu_forms_match_jax():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    for approximate in (True, False):
        np.testing.assert_allclose(gelu(t(x), approximate).numpy(),
                                   np.asarray(jax.nn.gelu(jnp.asarray(x), approximate)),
                                   **TOL)


@pytest.mark.parametrize("name,over", [("linear", {}), ("mlp_head", dict(linear_output=False)),
                                       ("goal_emb", dict(goal_dim=12))])
@pytest.mark.parametrize("uncond", [False, True])
def test_erf_forward_matches_flax(name, over, uncond):
    kw, jden, params, tden = make_models(seed=21, **ERF, **over)
    inputs = make_inputs(kw, B=5, seed=22)
    ref = _jax_forward(jden, params, inputs, uncond=uncond)
    with torch.no_grad():
        out = tden.inner_model(*(t(v) for v in inputs), uncond=uncond)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_erf_and_tanh_models_differ():
    """Same weights: the two GELU forms give outputs that differ well above
    the tolerance, so the erf tests have teeth."""
    kw, _, params, erf_den = make_models(seed=23, **ERF)
    inputs = [t(v) for v in make_inputs(kw, B=4, seed=24)]
    tanh_model = DiffusionGPT(**{**kw, "approximate_gelu": True})
    tanh_model.load_state_dict(erf_den.inner_model.state_dict())
    with torch.no_grad():
        d = (erf_den.inner_model(*inputs) - tanh_model(*inputs)).abs().max().item()
    assert d > 1e-4


@pytest.mark.parametrize("kind", ["GaussianFourier", "Sinusoidal", "FourierFeatures", "MLP"])
def test_sigma_embedding_forward_matches_flax(kind):
    kw, jden, params, tden = make_models(seed=25, sigma_embedding=kind)
    assert type(tden.inner_model.sigma_emb).__name__ == {
        "GaussianFourier": "GaussianFourierEmbedding", "Sinusoidal": "SinusoidalPosEmbedding",
        "FourierFeatures": "FourierFeatures", "MLP": "MLPTimeEmbedding"}[kind]
    inputs = make_inputs(kw, B=5, seed=26)
    with torch.no_grad():
        out = tden.inner_model(*(t(v) for v in inputs))
    np.testing.assert_allclose(out.numpy(), _jax_forward(jden, params, inputs), **TOL)
    # and back: the port's weights under flax names drive the flax model
    back = params_to_numpy_tree(tden.inner_model)
    assert sorted(back) == sorted(params)
    np.testing.assert_allclose(_jax_forward(jden, back, inputs), out.numpy(), **TOL)


@pytest.mark.parametrize("kind", sorted(temb.EMBEDDINGS))
def test_time_embedding_modules_match_flax(kind):
    D, B = 12, 7
    jm = jemb.make_time_embedding(kind, D)
    x = np.random.RandomState(27).uniform(-1.5, 0.5, size=B).astype(np.float32)
    variables = _redraw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 28)
    tm = temb.make_time_embedding(kind, D, torch.Generator().manual_seed(0))
    entries_from_jax(variables, embedding_entries(tm))
    ref = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = tm(t(x))
    assert out.shape == (B, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_gaussian_fourier_projection_is_fixed():
    """The fixed projection is a buffer: saved with the model, never trained
    (the reference's requires_grad=False, flax's "constants")."""
    m = DiffusionGPT(state_dim=4, action_dim=2, embed_dim=8, n_layers=1, n_heads=2,
                     goal_seq_len=1, obs_seq_len=2, sigma_embedding="GaussianFourier",
                     generator=torch.Generator().manual_seed(0))
    names = dict(m.named_parameters())
    assert "sigma_emb.proj.W" not in names and "sigma_emb.proj.W" in m.state_dict()
    assert abs(m.sigma_emb.proj.W.std().item() - 30.0) < 20.0


@pytest.mark.parametrize("activation", ["relu", "gelu", "mish", "tanh"])
@pytest.mark.parametrize("net", ["MLPNetwork", "ResidualMLPNetwork",
                                 "TwoLayerPreActivationResNetLinear"])
def test_mlps_match_flax(net, activation):
    n_in, hidden, B = 6, 10, 5
    if net == "TwoLayerPreActivationResNetLinear":
        jm, n_in = jmlps.TwoLayerPreActivationResNetLinear(hidden, activation), hidden
        tm = tmlps.TwoLayerPreActivationResNetLinear(hidden, activation,
                                                     torch.Generator().manual_seed(0))
    else:
        kw = dict(hidden_dim=hidden, num_hidden_layers=4, output_dim=3, activation=activation)
        jm = getattr(jmlps, net)(**kw)
        tm = getattr(tmlps, net)(n_in, **kw, generator=torch.Generator().manual_seed(0))
    x = np.random.RandomState(29).randn(B, n_in).astype(np.float32)
    variables = _redraw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 30)
    entries = mlp_entries(tm)
    assert len(entries) == len(jax.tree.leaves(variables)) // 2
    entries_from_jax(variables, entries)
    with torch.no_grad():
        out = tm(t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jm.apply(variables, jnp.asarray(x))),
                               **TOL)


def test_engines_refuse_other_sigma_embeddings():
    m = DiffusionGPT(state_dim=4, action_dim=2, embed_dim=8, n_layers=1, n_heads=2,
                     goal_seq_len=1, obs_seq_len=2, sigma_embedding="MLP")
    with pytest.raises(NotImplementedError, match="Linear"):
        extract_gpt_params(m)
    with pytest.raises(NotImplementedError, match="Linear"):
        prepare_fused_gpt(m)


# ---- kernels B1-B4, erf form: plain versions against the Pallas kernels ---------

def test_b1_erf_plain_matches_jax_tpu_kernel():
    D, H, P, T2, S, M, B = 48, 2, 3, 8, 3, 9, 8
    rng = np.random.RandomState(31)
    f = np.float32
    x, pk, pv = (rng.randn(*s).astype(f) for s in ((B, T2, D), (S, B, P, D), (S, B, P, D)))
    epi = (rng.rand(D).astype(f) + 0.5, 0.1 * rng.randn(D).astype(f),
           (rng.randn(M, D) / np.sqrt(D)).astype(f), 0.1 * rng.randn(M).astype(f))
    lw = layer_weights(D, seed=32)
    idx = np.asarray([S - 1], np.int32)
    Mp = -(-M // 8) * 8
    jepi = (jnp.asarray(epi[0][:, None]), jnp.asarray(epi[1][:, None]),
            jnp.asarray(np.pad(epi[2], ((0, Mp - M), (0, 0)))),
            jnp.asarray(np.pad(epi[3], (0, Mp - M))[:, None]))
    x_tl = x.reshape(B // E, E, T2, D).transpose(0, 3, 2, 1).reshape(B // E, D, T2 * E)
    jout, jpred = jfl.fused_layer_prefix_tl_v2(
        jnp.asarray(x_tl), prefix_tl(pk, H), prefix_tl(pv, H), jnp.asarray(idx),
        jax_layer(lw, H), n_heads=H, head_dim=D // H, suffix_len=T2, epilogue=jepi,
        interpret=True, **ERF)
    out, pred = fl.fused_layer_prefix_reference(
        t(x), t(pk), t(pv), t(idx), port_layer(lw, H), n_heads=H,
        epilogue=fl.FusedEpilogue(*(t(a) for a in epi)), **ERF)
    np.testing.assert_allclose(out.numpy(), from_tl(jout, B, T2), **TOL)
    np.testing.assert_allclose(pred.numpy(), from_tl(jpred, B, T2)[..., :M], **TOL)
    tanh = fl.fused_layer_prefix_reference(t(x), t(pk), t(pv), t(idx), port_layer(lw, H),
                                           n_heads=H)
    assert (tanh - out).abs().max().item() > 1e-4


def test_b2_erf_plain_matches_jax_layer_group():
    D, H, P, T2, S, B, n = 48, 2, 3, 8, 3, 8, 2
    rng = np.random.RandomState(33)
    f = np.float32
    x = rng.randn(B, T2, D).astype(f)
    pks = [rng.randn(S, B, P, D).astype(f) for _ in range(n)]
    pvs = [rng.randn(S, B, P, D).astype(f) for _ in range(n)]
    lws = [layer_weights(D, seed=34 + i) for i in range(n)]
    idx = np.asarray([1], np.int32)
    x_tl = x.reshape(B // E, E, T2, D).transpose(0, 3, 2, 1).reshape(B // E, D, T2 * E)
    jout = jfl.fused_layers_prefix_tl_v2_group(
        jnp.asarray(x_tl), [prefix_tl(a, H) for a in pks], [prefix_tl(a, H) for a in pvs],
        jnp.asarray(idx), [jax_layer(lw, H) for lw in lws], n_heads=H, head_dim=D // H,
        suffix_len=T2, interpret=True, **ERF)
    out = fl.fused_layers_prefix_group_reference(
        t(x), [t(a) for a in pks], [t(a) for a in pvs], t(idx),
        [port_layer(lw, H) for lw in lws], n_heads=H, **ERF)
    np.testing.assert_allclose(out.numpy(), from_tl(jout, B, T2), **TOL)


def test_b3_erf_plain_matches_jax_fused_layer_with_prefix():
    D, H, P, T2, B = 40, 4, 2, 10, 8
    rng = np.random.RandomState(35)
    x, pk, pv = (rng.randn(B, n, D).astype(np.float32) for n in (T2, P, P))
    lw = layer_weights(D, seed=36)
    ref = jfl.fused_layer_with_prefix(
        to_tdb(x), prefix_tdb(pk, H), prefix_tdb(pv, H), jax_layer(lw, H),
        n_heads=H, head_dim=D // H, env_block=E, interpret=True, **ERF)
    out = fl.fused_layer_with_prefix_reference(t(x), t(pk), t(pv), port_layer(lw, H),
                                               n_heads=H, **ERF)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).transpose(2, 0, 1), **TOL)


@pytest.mark.parametrize("H,hd,T", [(6, 60, 11), (12, 20, 12)])
def test_b4_erf_plain_matches_jax_fused_layer(H, hd, T):
    D, B = H * hd, 8
    lw = layer_weights(D, seed=37 + T)
    x = np.random.RandomState(T).randn(B, T, D).astype(np.float32)
    ref = jfl.fused_layer(to_tdb(x), jax_layer(lw, H), n_heads=H, head_dim=hd,
                          env_block=E, interpret=True, **ERF)
    out = fl.fused_layer_reference(t(x), port_layer(lw, H), n_heads=H, **ERF)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).transpose(2, 0, 1), **TOL)


# ---- engines on an erf model -------------------------------------------------

@pytest.mark.parametrize("uncond", [False, True])
def test_erf_uncached_engine_matches_jax(uncond):
    kw, jden, params, tden = make_models(seed=41, **ERF)
    s, a, g, sig = make_inputs(kw, B=8, seed=42)
    jfn = jax.jit(functools.partial(
        jfused.make_fused_denoise_fn(jden, params, env_block=E, interpret=True),
        uncond=uncond))
    ref = jfn(*(jnp.asarray(v) for v in (s, a, g, sig)))
    out = make_fused_denoise_fn(tden)(t(s), t(a), t(g), t(sig), uncond=uncond)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ENGINE_TOL)


@pytest.mark.parametrize("form", ["b1", "b3", "b2"])
def test_erf_cached_engines_match_jax_forward(form):
    """The erf model's fused_cached engine (B1; token_lanes=False: B3;
    layer_group=2: B2) and the plain cached engine against the JAX erf
    denoiser's full forward at every grid sigma."""
    kw, jden, params, tden = make_models(seed=43, n_layers=3, **ERF)
    s, a, g, _ = make_inputs(kw, B=6, seed=44)
    form_kw = {"b1": {}, "b3": dict(token_lanes=False), "b2": dict(layer_group=2)}[form]
    fused = make_fused_cached_denoise_fn(tden, t(g), GRID, **form_kw)
    plain = make_cached_denoise_fn(tden, t(g), GRID)
    for sg in GRID:
        sig = np.full(6, sg, np.float32)
        ref = np.asarray(jden.apply(params, *(jnp.asarray(v) for v in (s, a, g, sig))))
        for dn in (fused, plain):
            np.testing.assert_allclose(dn(t(s), t(a), t(g), t(sig)).numpy(), ref, **ENGINE_TOL)


# ---- the reference .pth key space ------------------------------------------------

@pytest.mark.parametrize("over", [{}, dict(linear_output=False)], ids=["linear", "mlp_head"])
def test_pth_from_jax_export_loads_into_port(over, tmp_path):
    """JAX `export_torch_state_dict` -> a .pth -> the port's
    `load_torch_checkpoint` into an erf model: the JAX erf model's outputs."""
    kw, jden, params, _ = make_models(seed=45, **ERF, **over)
    torch.save(jck.export_torch_state_dict(params, kw["n_layers"]),
               tmp_path / "model_state_dict.pth")
    weights = tck.load_torch_checkpoint(str(tmp_path), kw["n_layers"])
    model = DiffusionGPT(**kw)
    tck.load_reference_weights(model, weights)
    inputs = make_inputs(kw, B=5, seed=46)
    with torch.no_grad():
        out = model(*(t(v) for v in inputs))
    np.testing.assert_allclose(out.numpy(), _jax_forward(jden, params, inputs), **TOL)


@pytest.mark.parametrize("over", [{}, dict(linear_output=False)], ids=["linear", "mlp_head"])
def test_pth_port_export_converts_in_jax(over):
    """The port's `export_torch_state_dict` -> JAX's
    `convert_torch_diffusion_gpt`: the flax tree the port's weights map to,
    and the same outputs."""
    kw, jden, params, tden = make_models(seed=47, **ERF, **over)
    sd = tck.export_torch_state_dict(tden.inner_model.state_dict(), kw["n_layers"])
    assert all(k.startswith("inner_model.") for k in sd)
    tree = jck.convert_torch_diffusion_gpt(sd, kw["n_layers"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"]):
        got = tree["params"]
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf))
    inputs = make_inputs(kw, B=4, seed=48)
    with torch.no_grad():
        out = tden.inner_model(*(t(v) for v in inputs))
    np.testing.assert_allclose(_jax_forward(jden, tree, inputs), out.numpy(), **TOL)


def test_pth_goal_emb_round_trip_and_missing(tmp_path):
    """A block-push-like model whose goals have their own embedding
    (goal_dim 12 != state_dim 10): the port's export carries goal_emb, its
    loader reads it back bit for bit; JAX's converter drops it; a checkpoint
    without it is refused at load time."""
    kw = dict(state_dim=10, action_dim=2, embed_dim=48, n_layers=2, n_heads=4, goal_seq_len=1,
              obs_seq_len=5, goal_dim=12, **ERF)
    src = DiffusionGPT(**kw, generator=torch.Generator().manual_seed(49))
    sd = tck.export_torch_state_dict(src.state_dict(), 2)
    assert "inner_model.goal_emb.weight" in sd
    assert "goal_emb" not in jck.convert_torch_diffusion_gpt(sd, 2)["params"]
    torch.save(sd, tmp_path / "model_state_dict.pth")
    dst = DiffusionGPT(**kw)
    tck.load_reference_weights(dst, tck.load_torch_checkpoint(str(tmp_path), 2))
    for name, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[name], v), name
    del sd["inner_model.goal_emb.weight"], sd["inner_model.goal_emb.bias"]
    with pytest.raises(ValueError, match="goal_emb"):
        tck.load_reference_weights(DiffusionGPT(**kw), tck.convert_torch_diffusion_gpt(sd, 2))
    shared = DiffusionGPT(**{**kw, "goal_dim": None})
    with pytest.raises(ValueError, match="goal_emb"):
        tck.load_reference_weights(shared, tck.convert_torch_diffusion_gpt(
            tck.export_torch_state_dict(src.state_dict(), 2), 2))


def test_pth_without_inner_model_prefix():
    kw, _, _, tden = make_models(seed=50)
    sd = tck.export_torch_state_dict(tden.inner_model.state_dict(), kw["n_layers"])
    bare = {k[len("inner_model."):]: v for k, v in sd.items()}
    a, b = (tck.convert_torch_diffusion_gpt(d, kw["n_layers"]) for d in (sd, bare))
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_agent_load_torch_checkpoint(tmp_path):
    """`BesoAgent.load_torch_checkpoint`: the weights into the model and the
    EMA shadow started afresh from them."""
    from beso_tpu_torch.agents.beso_agent import BesoAgent, BesoAgentConfig

    cfg = BesoAgentConfig(hidden_dim=48, n_layers=2, n_heads=2)
    src = DiffusionGPT(state_dim=30, action_dim=9, embed_dim=48, n_layers=2, n_heads=2,
                       goal_seq_len=2, obs_seq_len=4, generator=torch.Generator().manual_seed(51))
    torch.save(tck.export_torch_state_dict(src.state_dict(), 2), tmp_path / "w.pth")
    agent = BesoAgent(cfg, None, device="cpu")
    agent.init(torch.Generator().manual_seed(0))
    agent.state.ema.num_updates = 7
    agent.load_torch_checkpoint(str(tmp_path), "w.pth")
    for name, p in src.named_parameters():
        assert torch.equal(dict(agent.state.model.named_parameters())[name], p), name
        assert torch.equal(agent.state.ema.params[name], p), name
    assert agent.state.ema.num_updates == 0
