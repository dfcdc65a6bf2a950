"""Kernel B1's port: the plain version of `fused_layer_prefix` against the
JAX TPU kernel `fused_layer_prefix_tl_v2` (interpret mode, f32) and against
the port's plain cached engine; the wrapper's CPU dispatch and checks.

The CUDA kernel itself runs only on the card: `test_kernel_matches_plain`
is marked `gpu` and skips here (chip_smoke.py runs the same comparison).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (TOL, jax_layer, layer_weights, make_inputs,
                          make_models, port_layer, t)

from beso_tpu.ops import fused_layer as jfl
from beso_tpu_torch.models.cached import (build_prefix, extract_gpt_params,
                                          grid_index, suffix_forward)
from beso_tpu_torch.models.gpt import layer_norm
from beso_tpu_torch.ops import build
from beso_tpu_torch.ops import fused_layer as fl


def _case(D, H, P, T2, S, M, B, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(B, T2, D).astype(f)
    pk = rng.randn(S, B, P, D).astype(f)
    pv = rng.randn(S, B, P, D).astype(f)
    epi = (rng.rand(D).astype(f) + 0.5, 0.1 * rng.randn(D).astype(f),
           (rng.randn(M, D) / np.sqrt(D)).astype(f), 0.1 * rng.randn(M).astype(f))
    return x, pk, pv, layer_weights(D, seed + 1), epi


# (D, H, P, T2, S, M, qbatch, epilogue): kitchen-like and push-like heads
JAX_CASES = {
    "kitchen_like": (48, 2, 3, 8, 3, 9, False, True),
    "push_like": (40, 4, 2, 10, 2, 2, True, False),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_plain_matches_jax_tpu_kernel(name):
    D, H, P, T2, S, M, qbatch, use_epi = JAX_CASES[name]
    B, E = 8, 8
    x, pk, pv, lw, epi = _case(D, H, P, T2, S, M, B, seed=11)
    idx = np.asarray([S - 1], np.int32)

    # JAX: token-merged-lanes layout, head dim padded to hdp >= 32
    jp = jax_layer(lw, H)
    hd, hdp = D // H, jfl.padded_head_dim(D // H)

    def kv_tl(a):   # [S, B, P, D] -> [S, nB, H*hdp, P*E]
        a = np.pad(a.reshape(S, B, P, H, hd), [(0, 0)] * 4 + [(0, hdp - hd)])
        a = a.reshape(S, B // E, E, P, H * hdp).transpose(0, 1, 4, 3, 2)
        return jnp.asarray(a.reshape(S, B // E, H * hdp, P * E))

    x_tl = x.reshape(B // E, E, T2, D).transpose(0, 3, 2, 1).reshape(B // E, D, T2 * E)
    jepi = None
    if use_epi:
        Mp = -(-M // 8) * 8
        jepi = (jnp.asarray(epi[0][:, None]), jnp.asarray(epi[1][:, None]),
                jnp.asarray(np.pad(epi[2], ((0, Mp - M), (0, 0)))),
                jnp.asarray(np.pad(epi[3], (0, Mp - M))[:, None]))
    jout = jfl.fused_layer_prefix_tl_v2(
        jnp.asarray(x_tl), kv_tl(pk), kv_tl(pv), jnp.asarray(idx), jp,
        n_heads=H, head_dim=hd, suffix_len=T2, qbatch=qbatch, epilogue=jepi,
        interpret=True)

    def from_tl(a):   # [nB, C, T2*E] -> [B, T2, C]
        a = np.asarray(a)
        return a.reshape(B // E, a.shape[1], T2, E).transpose(0, 3, 2, 1).reshape(B, T2, -1)

    tepi = fl.FusedEpilogue(*(t(a) for a in epi)) if use_epi else None
    out = fl.fused_layer_prefix_reference(
        t(x), t(pk), t(pv), t(idx), port_layer(lw, H), n_heads=H, epilogue=tepi)
    if use_epi:
        np.testing.assert_allclose(out[0].numpy(), from_tl(jout[0]), **TOL)
        np.testing.assert_allclose(out[1].numpy(), from_tl(jout[1])[..., :M], **TOL)
    else:
        np.testing.assert_allclose(out.numpy(), from_tl(jout), **TOL)


@pytest.mark.parametrize("epilogue", [False, True])
def test_plain_chain_matches_suffix_forward(epilogue):
    """Six-layer use as the fused engine makes it, against the plain cached
    engine's `suffix_forward`: same prefix cache, same grid row."""
    kw, _, _, tden = make_models(seed=21, n_layers=3)
    model = tden.inner_model
    s, a, g, _ = make_inputs(kw, B=6, seed=22)
    sigmas = np.asarray([1.0, 0.18, 0.032], np.float32)
    rp = extract_gpt_params(model)
    with torch.no_grad():
        prefix = build_prefix(model, rp, t(g), sigmas)
        sig = torch.full((6,), 0.18)
        ref = suffix_forward(model, rp, prefix, t(s), t(a), sig)
        S, L, B, P = prefix.k.shape[:4]
        D, H = model.embed_dim, model.n_heads
        idx = grid_index(sig, prefix.sigmas).to(torch.int32)
        assert idx.tolist() == [1]
        x = model.embed_suffix(t(s), t(a))
        w, b = rp.head
        epi = fl.FusedEpilogue(rp.lnf_scale, rp.lnf_bias, w, b)
        for li, lp in enumerate(rp.layers):
            last = epilogue and li == L - 1
            x = fl.fused_layer_prefix(
                x, prefix.k[:, li].reshape(S, B, P, D),
                prefix.v[:, li].reshape(S, B, P, D), idx,
                fl.prepare_layer_params(lp, H, torch.float32), n_heads=H,
                epilogue=epi if last else None)
        if epilogue:
            out = x[1][:, 1::2]
        else:
            out = model.head(layer_norm(x, rp.lnf_scale, rp.lnf_bias,
                                        torch.float32)[:, 1::2])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_wrapper_cpu_dispatch_counts_no_launch():
    x, pk, pv, lw, _ = _case(48, 2, 3, 8, 3, 9, 5, seed=31)
    p = port_layer(lw, 2)
    idx = torch.tensor([2], dtype=torch.int32)
    before = fl.fused_layer_prefix.launches
    out = fl.fused_layer_prefix(t(x), t(pk), t(pv), idx, p, n_heads=2)
    ref = fl.fused_layer_prefix_reference(t(x), t(pk), t(pv), idx, p, n_heads=2)
    assert fl.fused_layer_prefix.launches == before
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fl.fused_layer_prefix(t(x).to("meta"), t(pk), t(pv), idx, p, n_heads=2)


@pytest.mark.parametrize("D,H,shapes", [
    (360, 6, dict(wqkv=(1152, 368), wproj=(368, 384), wfc=(1440, 368),
                  wfc2=(368, 1440), bqkv=(1152,), bproj=(368,))),
    (240, 12, dict(wqkv=(1152, 240), wproj=(240, 384), wfc=(960, 240),
                   wfc2=(240, 960), bqkv=(1152,), bproj=(240,))),
])
def test_prepare_pads_to_16(D, H, shapes):
    """Kitchen (hd 60 -> 64, D 360 -> 368) and block push (hd 20 -> 32);
    padding is zero, and the bf16 weights are contiguous."""
    lw = layer_weights(D, seed=41)
    p = port_layer(lw, H, torch.bfloat16)
    for name, shape in shapes.items():
        assert tuple(getattr(p, name).shape) == shape
        assert getattr(p, name).is_contiguous()
    assert p.wqkv.dtype == torch.bfloat16 and p.bqkv.dtype == torch.float32
    hd = D // H
    hdp = -(-hd // 16) * 16
    q = p.wqkv.float().reshape(3, H, hdp, -1)
    assert q[:, :, hd:].abs().sum() == 0 and q[..., D:].abs().sum() == 0
    assert p.wproj.float().reshape(-1, H, hdp)[:, :, hd:].abs().sum() == 0


@pytest.mark.parametrize("D,H", [(360, 6), (240, 12)], ids=["kitchen", "block_push"])
def test_tiles_round_trip_to_padded_weights(D, H):
    """The kernel's tiled copy (`tile_layer_weights`) holds exactly the
    padded weights of FusedLayerParams, chunk by chunk in the kernel's order
    and core-matrix layout, with zeros in all of its own padding; every chunk
    fits one ring slot; a layer in a dtype no kernel takes (f64) carries no
    tiles."""
    p = port_layer(layer_weights(D, seed=43), H, torch.bfloat16)
    hdp, Dp, Fp = p.wqkv.shape[0] // (3 * H), p.wqkv.shape[1], p.wfc.shape[0]
    # first core matrix: head 0's q rows 0-7, columns 0-7, row-major
    assert torch.equal(p.tiles[:64].reshape(8, 8), p.wqkv[:8, :8])
    off, prods = 0, []
    for wt in fl.layer_products(p, H):
        N, K = wt.shape
        cols = []
        for ks in fl.chunk_steps(N, K // 16):
            n = N * 16 * ks
            assert 2 * n <= fl.SLOT_BYTES or ks == 1
            cols.append(p.tiles[off:off + n].reshape(2 * ks, N // 8, 8, 8)
                        .permute(1, 2, 0, 3).reshape(N, 16 * ks))
            off += n
        prods.append(torch.cat(cols, 1))
    assert off == p.tiles.numel()
    qkv = torch.stack([w.reshape(3, hdp, Dp) for w in prods[:H]], 1).reshape(-1, Dp)
    assert torch.equal(qkv, p.wqkv)
    proj, fc = prods[H], torch.cat(prods[H + 1::2], 0)
    fc2 = torch.cat(prods[H + 2::2], 1)
    assert torch.equal(proj[:Dp], p.wproj) and not proj[Dp:].any()
    assert torch.equal(fc[:Fp], p.wfc) and not fc[Fp:].any()
    assert torch.equal(fc2[:Dp, :Fp], p.wfc2)
    assert not fc2[Dp:].any() and not fc2[:, Fp:].any()
    assert port_layer(layer_weights(D, seed=43), H, torch.float64).tiles is None


@pytest.mark.parametrize("D,H", [(360, 6), (240, 12)], ids=["kitchen", "block_push"])
def test_f32_tiles_reconstruct_padded_weights(D, H):
    """An f32 layer's tiled copy: each ring chunk is a bf16 hi part then a
    lo part in the core-matrix layout, the chunks fit the f32 kernel's ring
    slot, and hi + lo gives back the padded f32 weights within 2^-16 of
    their largest magnitude, product by product in the kernel's order."""
    p = port_layer(layer_weights(D, seed=47), H, torch.float32)
    assert p.wqkv.dtype == torch.float32 and p.tiles.dtype == torch.bfloat16
    off = 0
    for wt in fl.layer_products(p, H):
        N, K = wt.shape
        cols = []
        for ks in fl.chunk_steps(N, K // 16, f32=True):
            n = N * 16 * ks
            assert 2 * 2 * n <= fl.F32_SLOT_BYTES
            hi, lo = (p.tiles[off + i * n:off + (i + 1) * n].float()
                      .reshape(2 * ks, N // 8, 8, 8).permute(1, 2, 0, 3).reshape(N, 16 * ks)
                      for i in (0, 1))
            assert torch.equal(hi, hi.bfloat16().float())
            cols.append(hi + lo)
            off += 2 * n
        got = torch.cat(cols, 1)
        assert (got - wt).abs().max() <= 2 ** -16 * wt.abs().max()
    assert off == p.tiles.numel()


def _f32_product_shape(p, H, Dp, hdp, Dq, n_mlp):
    """(N, k-steps) of product p of an f32 layer, as the f32 kernel's
    `product_shape` gives them: per head [q|k|v] then its proj columns, then
    per MLP chunk fc and fc2."""
    if p < 2 * H:
        return (Dq, hdp // 16) if p % 2 else (3 * hdp, Dp // 16)
    return (Dq, fl.MLP_CHUNK // 16) if (p - 2 * H) % 2 else (fl.MLP_CHUNK, Dp // 16)


@pytest.mark.parametrize("D,H", [(360, 6), (240, 12)], ids=["kitchen", "block_push"])
def test_f32_tiles_in_kernel_consumption_order(D, H):
    """Walk the f32 kernel's ring in its consumption order (`product_shape`
    and `Producer.issue`: per product its chunks of `chunk_steps(f32=True)`,
    each chunk a hi then a lo part in one ring slot, one bulk copy of a
    multiple of 16 bytes): every chunk fits a slot, the chunks' bytes add up
    to the tiled copy, and the hi and lo parts rebuild the padded weights
    within 2^-16 of their largest magnitude: [q|k|v] and proj head by head,
    then fc and fc2 per MLP chunk."""
    p = port_layer(layer_weights(D, seed=53), H, torch.float32)
    hdp, Dp, Fp = p.wqkv.shape[0] // (3 * H), p.wqkv.shape[1], p.wfc.shape[0]
    Dq, n_mlp = -(-Dp // 128) * 128, -(-Fp // fl.MLP_CHUNK)
    tiles = p.tiles.float()
    off, got = 0, []
    for prod in range(2 * H + 2 * n_mlp):
        N, ksteps = _f32_product_shape(prod, H, Dp, hdp, Dq, n_mlp)
        cols = []
        for kn in fl.chunk_steps(N, ksteps, f32=True):
            part = N * 16 * kn          # elements of one part
            assert 2 * 2 * part <= fl.F32_SLOT_BYTES and (2 * 2 * part) % 16 == 0
            hi, lo = (tiles[off + i * part:off + (i + 1) * part]
                      .reshape(2 * kn, N // 8, 8, 8).permute(1, 2, 0, 3).reshape(N, 16 * kn)
                      for i in (0, 1))
            cols.append(hi + lo)
            off += 2 * part
        got.append(torch.cat(cols, 1))
    assert off == p.tiles.numel()

    def close(a, b):
        return (a - b).abs().max() <= 2 ** -16 * b.abs().max()

    qkv = torch.stack([g.reshape(3, hdp, Dp) for g in got[:2 * H:2]], 1).reshape(-1, Dp)
    assert close(qkv, p.wqkv)
    proj = torch.cat(got[1:2 * H:2], 1)
    assert close(proj[:Dp], p.wproj) and not proj[Dp:].any()
    fc, fc2 = torch.cat(got[2 * H::2], 0), torch.cat(got[2 * H + 1::2], 1)
    assert close(fc[:Fp], p.wfc) and not fc[Fp:].any()
    assert close(fc2[:Dp, :Fp], p.wfc2) and not fc2[Dp:].any() and not fc2[:, Fp:].any()


def test_library_path_keyed_by_sources():
    path = build.kernel_library_path()
    assert path == build.kernel_library_path()
    assert path.name.startswith("libbeso_kernels_") and path.suffix == ".so"
    assert path.parent.parts[-2:] == ("build", "kernels")


@pytest.mark.gpu
def test_kernel_matches_plain():
    """On the card: the CUDA kernel against its plain version in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this on the H100")
    dev = torch.device("cuda")
    x, pk, pv, lw, epi = _case(360, 6, 3, 8, 3, 9, 37, seed=51)
    p = fl.FusedLayerParams(*(v.to(dev) for v in port_layer(lw, 6, torch.bfloat16)))
    e = fl.FusedEpilogue(*(t(a).to(dev) for a in epi))
    args = [t(v).to(dev, torch.bfloat16) for v in (x, pk, pv)]
    idx = torch.tensor([1], dtype=torch.int32, device=dev)
    out, pred = fl.fused_layer_prefix(*args, idx, p, n_heads=6, epilogue=e)
    ref, ref_pred = fl.fused_layer_prefix_reference(*args, idx, p, n_heads=6,
                                                    epilogue=e)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max() <= 2 ** -5 * ref.float().abs().max()
    assert (pred - ref_pred).abs().max() <= 2 ** -5 * ref_pred.abs().max()
