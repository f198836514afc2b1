"""The port's model zoo (models/{vit,mae,swin,vit_codec,csa,gnn,propagnet,
vae,pos_embed}.py) against the JAX package's, on the CPU at small widths.

Each case initialises the JAX module, carries its variables into the port's
module (``weights.state_dict_from_flax``) and feeds both the same seeded
numpy input; where a module draws (masking noise, the reparameterisation,
prior samples) the port is given JAX's draws. Images go to the port as NCHW
and come back to NHWC at this boundary. Tolerances, from float32 products
summed in another order: outputs within 2e-5 of their largest magnitude
(1e-4 for the CVAE, whose GDN and BatchNorm divide, and parameter
gradients; 5e-4 for the 24-layer ViT codec, see VIT_CODEC_RTOL); masks, ids and
patch tables exactly; the sin-cos tables exactly and the cubic resize
within 1e-6 of the table's peak.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu import models as J
from gnuradio_wifi_imagetransfer_tpu.models import gnn as jgnn
from gnuradio_wifi_imagetransfer_tpu.models import mae as jmae
from gnuradio_wifi_imagetransfer_tpu.models import pos_embed as jpe
from gnuradio_wifi_imagetransfer_tpu.models import propagnet as jprop
from gnuradio_wifi_imagetransfer_tpu.models import swin as jswin
from gnuradio_wifi_imagetransfer_tpu_torch import models as P
from gnuradio_wifi_imagetransfer_tpu_torch.models import gnn, mae, pos_embed, propagnet, swin
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt

torch.set_num_threads(2)

RTOL = 2e-5
# the ViT codec stacks 12 talking-heads layers a direction, whose N(0, 1)
# head mixes amplify the rounding: the port's float32 encoder and JAX's each
# lie 1-2e-4 of the peak from the port's float64 run
VIT_CODEC_RTOL = 5e-4
KEY = jax.random.PRNGKey(0)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _carry(variables, port):
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port.load_state_dict(wt.state_dict_from_flax(variables, port))
    return port.eval()


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-6))


def _pair(jmod, port, *args, rngs=None):
    """(JAX variables carried into port, JAX output on args)."""
    def init_apply(key):
        variables = jmod.init(key, *args)
        return variables, jmod.apply(variables, *args)

    variables, out = jax.jit(init_apply)(rngs or KEY)
    return _carry(variables, port), out


# -- the carrier ------------------------------------------------------------


def test_carrier_on_attention_embed_and_raw_leaves():
    x = _rand((2, 5, 32))
    blk, want = _pair(jmae.TimmBlock(32, 4), mae.TimmBlock(32, 4, device="cpu"), x)
    assert set(blk.state_dict()) >= {"attn.query.weight", "attn.query.bias", "attn.out.weight"}
    _close(blk(torch.from_numpy(x)), want)

    ctx = _rand((2, 3, 32), seed=1)
    att, want = _pair(J.CrossAttention(32, heads=4, dim_head=8),
                      P.CrossAttention(32, heads=4, dim_head=8, device="cpu"), x, ctx)
    _close(att(torch.from_numpy(x), torch.from_numpy(ctx)), want)

    ids = np.array([[0, 5, 15], [3, 3, 1]])
    jemb = fnn.Embed(16, 8)
    emb, want = _pair(jemb, torch.nn.Embedding(16, 8), ids)
    assert np.array_equal(emb(torch.from_numpy(ids)).detach().numpy(), np.asarray(want))

    # a leaf of another shape is refused (4 heads' mixes into 2 heads')
    variables = {"params": {"mix_heads_pre_attn": np.zeros((4, 4), np.float32)}}
    with pytest.raises(ValueError, match=r"mix_heads_pre_attn: \(4, 4\) against"):
        wt.state_dict_from_flax(variables, P.CrossAttention(32, heads=2, dim_head=16,
                                                            device="cpu"))


# -- pos_embed --------------------------------------------------------------


def test_sincos_tables_exact():
    for dim, grid, cls in ((64, 4, False), (64, 4, True), (32, 7, True)):
        assert np.array_equal(pos_embed.get_2d_sincos_pos_embed(dim, grid, cls),
                              jpe.get_2d_sincos_pos_embed(dim, grid, cls))


@pytest.mark.parametrize("orig,new", [(4, 8), (8, 4), (5, 7)])
def test_interpolate_pos_embed_matches_jax_cubic(orig, new):
    pe = _rand((1, 1 + orig * orig, 16), seed=orig)
    got = pos_embed.interpolate_pos_embed(pe, new * new)
    want = jpe.interpolate_pos_embed(pe, new * new)
    assert np.array_equal(got[:, :1], pe[:, :1])
    _close(got, want, 1e-6)


# -- vit --------------------------------------------------------------------


def test_attention_and_feedforward():
    x = _rand((2, 6, 32))
    for jmod, port in ((J.Attention(32, heads=4, dim_head=8),
                        P.Attention(32, heads=4, dim_head=8, device="cpu")),
                       (J.Attention(32, heads=1, dim_head=32),
                        P.Attention(32, heads=1, dim_head=32, device="cpu")),
                       (J.FeedForward(32, 64), P.FeedForward(32, 64, device="cpu"))):
        port, want = _pair(jmod, port, x)
        _close(port(torch.from_numpy(x)), want)


def test_transformer_with_and_without_context():
    x, ctx = _rand((2, 5, 32)), _rand((2, 3, 32), seed=1)
    jmod = J.Transformer(dim=32, depth=2, heads=4, dim_head=8, mlp_dim=64)
    variables = jax.jit(jmod.init)(KEY, x, ctx)
    port = _carry(variables, P.Transformer(32, 2, 4, 8, 64, device="cpu"))
    want = jax.jit(lambda v: (jmod.apply(v, x, ctx), jmod.apply(v, x, None)))(variables)
    _close(port(torch.from_numpy(x), torch.from_numpy(ctx)), want[0])
    _close(port(torch.from_numpy(x)), want[1])


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_with_context(pool):
    img, ctx = _rand((2, 32, 32, 3)), _rand((2, 4, 96), seed=1)
    port, want = _pair(J.ViT(image_size=32, patch_size=8, dim=64, depth=2, heads=4,
                             mlp_dim=128, pool=pool, dim_head=16),
                       P.ViT(image_size=32, patch_size=8, dim=64, depth=2, heads=4, mlp_dim=128,
                             pool=pool, dim_head=16, device="cpu"), img, ctx)
    _close(port(_nchw(img), torch.from_numpy(ctx)), want)


def test_transformer_gradient_matches_jax_grad():
    """d/d(params, x) of sum(Transformer(x, ctx) * w) against jax.grad."""
    x, ctx, w = _rand((2, 5, 32)), _rand((2, 3, 32), seed=1), _rand((2, 5, 32), seed=2)
    jmod = J.Transformer(dim=32, depth=2, heads=4, dim_head=8, mlp_dim=64)
    variables = jax.jit(jmod.init)(KEY, x, ctx)
    gp, gx = jax.jit(jax.grad(lambda v, x: jnp.sum(jmod.apply(v, x, ctx) * w),
                              argnums=(0, 1)))(variables, x)
    port = _carry(variables, P.Transformer(32, 2, 4, 8, 64, device="cpu"))
    xt = torch.from_numpy(x).requires_grad_(True)
    (port(xt, torch.from_numpy(ctx)) * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, gx)
    want = wt.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, gp), port)
    for name, p in port.named_parameters():
        _close(p.grad, want[name].numpy(), 1e-4)


# -- mae --------------------------------------------------------------------


def test_mae_wrapper_with_jax_noise():
    img = _rand((2, 32, 32, 3))
    jmod = J.MAE(image_size=32, patch_size=8, encoder_dim=64, encoder_depth=1,
                 decoder_dim=32, decoder_depth=1, masking_ratio=0.75)
    variables = jax.jit(jmod.init)({"params": KEY, "mask": KEY}, img)
    port = _carry(variables, P.MAE(image_size=32, patch_size=8, encoder_dim=64, encoder_depth=1,
                                   decoder_dim=32, decoder_depth=1, device="cpu"))
    rng = jax.random.PRNGKey(3)
    noise = torch.from_numpy(np.array(jax.random.uniform(rng, (2, 16))))
    def run(v):
        dec, aux = jmod.apply(v, jnp.asarray(img), rng=rng, method=jmod.encode)
        return dec, aux["masked_idx"], aux["unmasked_idx"], *jmod.apply(
            v, dec, aux, method=jmod.decode)

    dec, *idx, want_loss, want_recon = jax.jit(run)(variables)
    aux = dict(zip(("masked_idx", "unmasked_idx"), idx))
    pdec, paux = port.encode(_nchw(img), noise=noise)
    for k in ("masked_idx", "unmasked_idx"):
        assert np.array_equal(paux[k].numpy(), np.asarray(aux[k]))
    _close(pdec, dec)
    loss, recon = port.decode(pdec, paux)
    _close(loss, want_loss)
    _close(_nhwc(recon), want_recon)
    assert float(port(_nchw(img), noise=noise)) == float(loss)
    with pytest.raises(ValueError, match="Generator"):
        port(_nchw(img))


@pytest.fixture(scope="module")
def fair_mae():
    jmod = J.MaskedAutoencoderViT(img_size=32, patch_size=8, embed_dim=64, depth=2,
                                  num_heads=4, decoder_embed_dim=32, decoder_depth=1,
                                  decoder_num_heads=4)
    img = _rand((2, 32, 32, 3))
    variables = jax.jit(jmod.init)({"params": KEY, "mask": KEY}, img)
    port = _carry(variables, P.MaskedAutoencoderViT(
        img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, decoder_embed_dim=32,
        decoder_depth=1, decoder_num_heads=4, device="cpu"))
    return jmod, variables, port, img


def test_masked_autoencoder_vit_with_jax_noise(fair_mae):
    jmod, variables, port, img = fair_mae
    rng = jax.random.PRNGKey(5)
    noise = torch.from_numpy(np.array(jax.random.uniform(rng, (2, 16))))
    want, (lat, mask, ids) = jax.jit(lambda v: (
        jmod.apply(v, img, 0.75, rng),
        jmod.apply(v, img, 0.75, rng, method=jmod.forward_encoder)))(variables)
    got = port(_nchw(img), 0.75, noise=noise)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].sum() == 24
    _close(got[1], want[1])
    _close(got[0], want[0])
    plat, pmask, pids = port.forward_encoder(_nchw(img), 0.75, noise)
    assert np.array_equal(pids.numpy(), np.asarray(ids)) and pids.dtype == torch.int64
    assert np.array_equal(pmask.numpy(), np.asarray(mask))
    _close(plat, lat)


def test_patchify_unpatchify_and_norm_pix_loss(fair_mae):
    jmod, variables, port, img = fair_mae
    patches = port.patchify(_nchw(img))
    assert np.array_equal(patches.numpy(), np.asarray(jmod.patchify(jnp.asarray(img))))
    assert torch.equal(port.unpatchify(patches), _nchw(img))
    pred, mask = _rand((2, 16, 192), seed=3), (np.arange(32).reshape(2, 16) % 3 == 0)
    mask = mask.astype(np.float32)
    jnorm = J.MaskedAutoencoderViT(img_size=32, patch_size=8, embed_dim=64, depth=2,
                                   num_heads=4, decoder_embed_dim=32, decoder_depth=1,
                                   decoder_num_heads=4, norm_pix_loss=True)
    port.norm_pix_loss = True
    try:
        got = port.forward_loss(_nchw(img), torch.from_numpy(pred), torch.from_numpy(mask))
    finally:
        port.norm_pix_loss = False
    _close(got, jnorm.forward_loss(jnp.asarray(img), pred, mask))


# -- swin -------------------------------------------------------------------


@pytest.mark.parametrize("res,window,shift", [((16, 16), 8, 4), ((16, 16), 8, 0), ((4, 4), 7, 3)])
def test_swin_block(res, window, shift):
    x = _rand((2, res[0] * res[1], 32))
    port, want = _pair(jswin.SwinTransformerBlock(32, res, 4, window, shift),
                       P.SwinTransformerBlock(32, res, 4, window, shift, device="cpu"), x)
    assert port.window_size == min(window, min(res)) and (port.shift_size > 0) == (
        shift > 0 and min(res) > window)
    _close(port(torch.from_numpy(x)), want)


def test_window_partition_and_tables():
    x = _rand((2, 16, 8, 3))
    w = swin.window_partition(torch.from_numpy(x), 4)
    assert np.array_equal(w.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), 4)))
    assert np.array_equal(swin.window_reverse(w, 4, 16, 8).numpy(), x)
    assert np.array_equal(swin.relative_position_index((7, 7)),
                          jswin._relative_position_index((7, 7)))
    assert np.array_equal(swin.shifted_window_mask(16, 16, 8, 4),
                          jswin._shifted_window_mask(16, 16, 8, 4))


@pytest.mark.parametrize("name,args", [
    ("PatchMerging", ((8, 8), 32)), ("PatchExpand2X", ((8, 8), 32)),
    ("PatchExpand2X", ((8, 8), 32, 1)), ("PatchExpand", ((8, 8), 32, 2)),
    ("DimReducePatchExpand", ((8, 8), 32, 2)), ("FinalPatchExpandX4", ((8, 8), 32))])
def test_patch_resamplers(name, args):
    x = _rand((2, 64, 32))
    port, want = _pair(getattr(J, name)(*args), getattr(P, name)(*args, device="cpu"), x)
    _close(port(torch.from_numpy(x)), want)


def test_patch_embed():
    img = _rand((2, 32, 32, 3))
    port, want = _pair(J.PatchEmbed(32, 4, 48, use_norm=True),
                       P.PatchEmbed(32, 4, 48, use_norm=True, device="cpu"), img)
    _close(port(_nchw(img)), want)


# -- vit_codec, csa, gnn, propagnet, vae --------------------------------------


def _flax_of(port) -> dict:
    """The Flax variables of a Transformer-family port module: the carrier
    run backwards for Linear, LayerNorm and the raw parameters (spares
    JAX's init, whose compile dominates at the ViT codec's depth)."""
    tree: dict = {}
    for prefix, m in port.named_modules():
        for name, t in m.named_parameters(recurse=False):
            v = t.detach().numpy()
            if isinstance(m, torch.nn.Linear) and name == "weight":
                name, v = "kernel", v.T
            elif isinstance(m, torch.nn.LayerNorm) and name == "weight":
                name = "scale"
            node = tree.setdefault("params", {})
            for part in prefix.split(".") if prefix else []:
                node = node.setdefault(part, {})
            node[name] = v
    return tree


def test_vit_codec_encoder_decoder():
    size, dim = 4, 32
    x, ctx = _rand((1, size * size, dim)), _rand((1, 4, 2 * dim), seed=1)
    torch.manual_seed(0)
    enc, dec = P.ViTEncoder(size, dim, 2, device="cpu"), P.ViTDecoder(1, 4 * dim, 2, device="cpu")
    jenc = J.ViTEncoder(input_size=size, patch_dim=dim, layer_depth=2)
    jdec = J.ViTDecoder(input_size=1, patch_dim=4 * dim, layer_depth=2)
    venc, vdec = _flax_of(enc), _flax_of(dec)
    for v, m in ((venc, enc), (vdec, dec)):
        assert all(torch.equal(t, m.state_dict()[k])
                   for k, t in wt.state_dict_from_flax(v, m).items())
    lat, want = jax.jit(lambda: (jenc.apply(venc, x, ctx),
                                 jdec.apply(vdec, jenc.apply(venc, x, ctx), ctx)))()
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.from_numpy(ctx))
        assert got.shape == (1, (size // 4) ** 2, 4 * dim)
        _close(got, lat, VIT_CODEC_RTOL)
        out = dec(torch.from_numpy(np.array(lat)), torch.from_numpy(ctx))
    assert out.shape == x.shape
    _close(out, want, VIT_CODEC_RTOL)


@pytest.mark.parametrize("snr", [20.0, [10.0, 20.0, 30.0]])
def test_csa_afb(snr):
    feat = _rand((2, 8, 8, 16))
    port, want = _pair(J.CSAAFB(snr=snr, channel_size=16),
                       P.CSAAFB(snr, channel_size=16, device="cpu"), feat)
    _close(_nhwc(port(_nchw(feat))), want)


def test_gcn_with_duplicate_edges():
    edges = np.array([[0, 1, 1, 2, 2, 3, 0, 0], [1, 0, 2, 1, 3, 2, 1, 1]])   # 0 -> 1 three times
    want_adj = np.asarray(jgnn.normalized_adjacency(jnp.asarray(edges), 4))
    adj = gnn.normalized_adjacency(edges, 4)
    assert float(adj[0, 1]) > float(adj[1, 0])                  # accumulated, not set
    _close(adj, want_adj, 1e-6)
    for shape in ((4, 3), (8, 4, 3)):
        x = _rand(shape)
        port, want = _pair(J.GNN(hidden_channels=8, out_channels=5),
                           P.GNN(8, 5, in_channels=3, device="cpu"), x, edges)
        _close(port(torch.from_numpy(x), torch.from_numpy(edges)), want)


@pytest.mark.parametrize("with_irs", [True, False])
def test_propagnet(with_irs):
    rng = np.random.default_rng(0)
    m, n, p = 4, 8, 3
    env = tuple((rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)
                for s in ((m, n), (n, p), (m, p)))
    x = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
    port, (y, csi) = _pair(jprop.PropagNet(env=env, with_irs=with_irs),
                           P.PropagNet(env, with_irs=with_irs, device="cpu"), x)
    py, pcsi = port(torch.from_numpy(x))
    _close(pcsi, csi)
    _close(py, y)
    assert pcsi.dtype == torch.complex64
    _close(port.get_csi(1), np.asarray(csi)[1])
    if not with_irs:
        _close(pcsi, env[2].T)
    phases = propagnet.refresh_psi(5, torch.Generator().manual_seed(0))
    assert phases.shape == (5,) and 0 <= float(phases.min()) and float(phases.max()) < 2 * 3.14


def test_conditional_vae_eval_with_jax_draws():
    """The port's initialisation carried to JAX (``weights.flax_from_module``,
    which spares JAX's costly init of the GDN convolutions), eval mode."""
    jmod = J.ConditionalVAE(in_channels=3, embedding_dim=4, compressed_channel=8, img_size=16)
    x = _rand((2, 16, 16, 3))
    y = np.eye(4, dtype=np.float32)[[0, 2]]
    torch.manual_seed(0)
    port = P.ConditionalVAE(3, 4, 8, 16, device="cpu").eval()
    # batch statistics away from (0, 1), so the eval-mode BatchNorm counts
    port.final_bn.running_mean.copy_(torch.tensor([0.1, -0.2, 0.05]))
    port.final_bn.running_var.copy_(torch.tensor([0.5, 2.0, 1.5]))
    variables = wt.flax_from_module(port)
    assert set(variables["batch_stats"]) == {"final_bn"}
    rng, srng = jax.random.PRNGKey(7), jax.random.PRNGKey(9)
    (recons, _, mu, log_var), sampled = jax.jit(lambda v: (
        jmod.apply(v, x, y, None, rng), jmod.apply(v, 2, y, srng, method=jmod.sample)))(variables)
    eps = torch.from_numpy(np.array(jax.random.normal(rng, mu.shape)))
    z = torch.from_numpy(np.array(jax.random.normal(srng, (2, jmod.latent_dim))))
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(y), eps=eps)
        samples = port.sample(2, torch.from_numpy(y), z=z)
    _close(got[2], mu, 1e-4)
    _close(got[3], log_var, 1e-4)
    _close(_nhwc(got[0]), recons, 1e-4)
    _close(_nhwc(samples), sampled, 1e-4)
    losses = P.vae_loss(got[0], got[1], got[2], got[3], kld_weight=0.01)
    want = J.vae_loss(recons, x, mu, log_var, kld_weight=0.01)
    for k in want:
        _close(losses[k], want[k], 1e-4)


def test_zoo_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for make in (lambda: P.ViT(image_size=32, patch_size=8, dim=32, depth=1),
                 lambda: mae.mae_vit_base_patch16(), lambda: P.GNN(4, 4),
                 lambda: P.ConditionalVAE(compressed_channel=8, img_size=16)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
