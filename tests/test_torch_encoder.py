"""The port's text path against the JAX package's, on the CPU.

Configs and the MarcoLike data are copies and compare equal. The layers
(norms, rotary at rope_pct 1.0 and 0.25, gelu/silu/relu MLPs) and
``encode`` run on the same inputs, made from a numpy seed, with the
reference's parameters carried across by ``convert.from_reference_params``.
``encode`` is held for ``thistle_sbert.SMOKE`` (every pool; S = 64 takes
the chunked attention on both sides, S = 16 the dense one) and for FULL
cut to 2 layers at full width, each with a fully padded row:

  * float32 (``dataclasses.replace(cfg, dtype="float32")``): atol 1e-4,
    rtol 1e-4 (the two sum in different orders);
  * bfloat16: cosine >= 0.999 for every row (each side rounds its bf16
    products and residuals, but not in the same places).

``load_texts``/``query_texts`` then return the reference ``VectorDB``'s
ids on the same texts, except between scores equal within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import thistle_sbert as jcfg  # noqa: E402
from repro.core import VectorDB as JaxVectorDB  # noqa: E402
from repro.data import marco as jmarco  # noqa: E402
from repro.models import encoder as jenc  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import VectorDB  # noqa: E402
from repro_torch.configs import thistle_sbert as pcfg  # noqa: E402
from repro_torch.core.convert import from_reference_params  # noqa: E402
from repro_torch.data import marco as pmarco  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import encoder as penc  # noqa: E402
from repro_torch.models import layers as players  # noqa: E402

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_MIN_COS = 0.999
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FULL2 = dict(n_layers=2)  # FULL at full width, cut to 2 layers


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _pair(x, dtype):
    return jnp.asarray(x, JDT[dtype]), torch.tensor(x).to(TDT[dtype])


# ----------------------------------------------------------- copies


@pytest.mark.parametrize("name", ["FULL", "SMOKE"])
def test_configs_equal_the_reference(name):
    assert (dataclasses.asdict(getattr(pcfg, name))
            == dataclasses.asdict(getattr(jcfg, name)))


def test_marco_and_tokenizer_equal_the_reference():
    kw = dict(n_passages=300, vocab_size=1000, passage_len=24, seed=3)
    j, p = jmarco.MarcoLike(**kw), pmarco.MarcoLike(**kw)
    np.testing.assert_array_equal(p.passages, j.passages)
    np.testing.assert_array_equal(p.queries(), j.queries())
    np.testing.assert_array_equal(p.queries(n=40), j.queries()[:40])
    assert p.passage_texts() == j.passage_texts()
    assert p.query_texts(n=17) == j.query_texts()[:17]
    for text in p.passage_texts()[:50] + ["", "w5 w5 w9"]:
        np.testing.assert_array_equal(
            pmarco.simple_tokenizer(text, 1000, 32),
            jmarco.simple_tokenizer(text, 1000, 32))


# ----------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_matches_reference(kind, dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 48)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=48).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)
    jp = {"scale": jnp.asarray(scale)}
    norm = players.Norm(kind, 48).requires_grad_(False)
    norm.scale.data = torch.tensor(scale)
    if kind == "layernorm":
        jp["bias"] = jnp.asarray(bias)
        norm.bias.data = torch.tensor(bias)
    jx, tx = _pair(x, dtype)
    got = players.apply_norm(norm, tx)
    assert got.dtype == TDT[dtype]
    tol = LAYER_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(jlayers.apply_norm(jp, jx)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rope_pct", [1.0, 0.25])
def test_rope_matches_reference(rope_pct, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 40, 3, 64)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    pos = np.arange(40)
    got = players.apply_rope(tx, torch.tensor(pos)[None], 10_000.0, rope_pct)
    want = jlayers.apply_rope(jx, jnp.asarray(pos)[None], 10_000.0, rope_pct)
    tol = LAYER_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    if rope_pct < 1.0:  # the rest passes through untouched
        np.testing.assert_array_equal(_f32(got)[..., 16:], _f32(tx)[..., 16:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,gated", [("gelu", False), ("silu", True),
                                       ("relu", False)])
def test_mlp_matches_reference(act, gated, dtype):
    rng = np.random.default_rng(2)
    jp = jlayers.init_mlp(jax.random.PRNGKey(0), 32, 96, gated, jnp.float32)
    mlp = players.MLP(torch.Generator().manual_seed(0), 32, 96,
                      gated).requires_grad_(False)
    for name, leaf in jp.items():
        getattr(mlp, name).data = torch.tensor(np.asarray(leaf))
    x = rng.normal(size=(4, 7, 32)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    tol = LAYER_TOL[dtype]
    np.testing.assert_allclose(_f32(players.apply_mlp(mlp, tx, act)),
                               _f32(jlayers.apply_mlp(jp, jx, act)),
                               atol=tol, rtol=tol)


def test_trunc_normal_init_stays_within_two_std():
    g = torch.Generator().manual_seed(0)
    w = players.dense_init(g, 400, 300).detach()
    std = 1 / np.sqrt(400)
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) / std - 0.88) < 0.02  # std of N(0,1) cut at +-2


# ----------------------------------------------------------- encode

_PARAMS = {}


def _reference_params(cfg):
    """The reference's seeded init, as a numpy tree (cached a config)."""
    key = (cfg.name, cfg.n_layers, cfg.project_dim)
    if key not in _PARAMS:
        _PARAMS[key] = jax.tree.map(np.asarray,
                                    jenc.init(cfg, jax.random.PRNGKey(7)))
    return _PARAMS[key]


def _port_model(jc, pc):
    model = penc.init(pc, torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(from_reference_params(_reference_params(jc), pc),
                          strict=True)
    return model


def _tokens(rng, B, S, vocab):
    tok = rng.integers(2, vocab, size=(B, S)).astype(np.int32)
    lengths = rng.integers(1, S + 1, size=B)
    lengths[0] = S
    lengths[-1] = 0  # a fully padded row: an empty text
    mask = np.arange(S)[None, :] < lengths[:, None]
    return np.where(mask, tok, 0), mask


def _check_rows(got, want, dtype, pool):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)  # NaN where NaN
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    rows = ~np.isnan(want).any(axis=1)
    norms = np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1)
    live = rows & (norms > 0)
    cos = (got * want).sum(axis=1)[live] / norms[live]
    assert cos.min() >= BF16_MIN_COS, cos
    # an empty text embeds to zero under mean pooling, on both sides
    np.testing.assert_array_equal(got[rows & (norms == 0)],
                                  want[rows & (norms == 0)])
    if pool == "mean":
        assert not np.any(got[-1]) and not np.any(want[-1])


ENCODE_CASES = [
    # (config, overrides, S, pool): SMOKE at every pool, dense (S = 16) and
    # chunked (S = 64) attention; a projection; FULL at its own pool
    *(("SMOKE", {}, S, pool) for S in (16, 64) for pool in ("mean", "cls", "max")),
    ("SMOKE", {"project_dim": 24}, 16, "mean"),
    ("FULL", FULL2, 32, "mean"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,over,S,pool", ENCODE_CASES)
def test_encode_matches_reference(name, over, S, pool, dtype):
    jc = dataclasses.replace(getattr(jcfg, name), dtype=dtype, pool=pool, **over)
    pc = dataclasses.replace(getattr(pcfg, name), dtype=dtype, pool=pool, **over)
    model = _port_model(jc, pc)
    rng = np.random.default_rng(S + len(name))
    tok, mask = _tokens(rng, 5, S, pc.vocab_size)
    ops.reset_launch_counts()
    got = penc.encode(model, pc, tok, mask).numpy()
    assert ops.launch_counts()["flash_attention"] == 0  # the CPU's plain path
    want = np.asarray(jenc.encode(_reference_params(jc), jc, jnp.asarray(tok),
                                  jnp.asarray(mask)), np.float32)
    assert got.shape == want.shape == (5, pc.project_dim or pc.d_model)
    _check_rows(got, want, dtype, pool)


def test_from_reference_params_unstacks_layers_and_drops_lm_head():
    """Layers unstacked; ``lm_head``, which the port's model now holds (the
    encoder never reads it, but train states carry it), comes across as
    it is (the name is older than that)."""
    jc = dataclasses.replace(jcfg.SMOKE, n_layers=3)
    tree = _reference_params(jc)
    assert "lm_head" in tree
    sd = from_reference_params(tree, dataclasses.replace(pcfg.SMOKE, n_layers=3))
    np.testing.assert_array_equal(sd["lm_head.w"].numpy(), tree["lm_head"]["w"])
    for i in range(3):
        np.testing.assert_array_equal(sd[f"dense_blocks.{i}.attn.wq"].numpy(),
                                      tree["dense_blocks"]["attn"]["wq"][i])
    assert sd["dense_blocks.2.attn.wo"].shape == (4, 16, 64)  # (h, dh, d)
    with pytest.raises(ValueError, match="stacks 3 layers"):
        from_reference_params(tree, pcfg.SMOKE)


def test_init_refuses_mla_and_moe():
    """MLA and MoE blocks are built since the LM serving slice, and since
    the LM training slice they bind for training too: each MoE layer's
    expert leaf becomes a view of the stacked (L, E, d, f) tensor."""
    from repro_torch.configs.base import MLAConfig, MoEConfig
    from repro_torch.core.convert import bind_reference_layout
    g = torch.Generator().manual_seed(0)
    mla = penc.init(dataclasses.replace(pcfg.SMOKE, mla=MLAConfig(
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)), g,
        "cpu")
    assert mla.dense_blocks[0].attn.wkv_b.shape == (32, 4, 32)
    cfg = dataclasses.replace(pcfg.SMOKE, moe=MoEConfig(4, 2, d_ff_expert=32),
                              first_k_dense=1)
    moe = penc.init(cfg, g, "cpu")
    assert moe.moe_blocks[0].moe.experts.w_up.shape == (4, 64, 32)
    tree = bind_reference_layout(moe, cfg)
    stacked = tree["moe_blocks"]["moe"]["experts"]["w_up"]
    assert stacked.shape == (1, 4, 64, 32)
    with torch.no_grad():
        stacked[0, 1].fill_(3.0)
    assert bool((moe.moe_blocks[0].moe.experts.w_up[1] == 3.0).all())


# ----------------------------------------------------------- text path


def _text_encoder(enc_fn, tokenizer, cfg, seq_len):
    def encode_texts(texts):
        tok = np.stack([tokenizer(t, cfg.vocab_size, seq_len) for t in texts])
        return enc_fn(tok, tok != 0)
    return encode_texts


def test_load_and_query_texts_match_reference():
    jc = dataclasses.replace(jcfg.SMOKE, dtype="float32")
    pc = dataclasses.replace(pcfg.SMOKE, dtype="float32")
    model = _port_model(jc, pc)
    jparams = _reference_params(jc)
    data = pmarco.MarcoLike(n_passages=160, vocab_size=pc.vocab_size,
                            passage_len=24, seed=0)
    passages, queries = data.passage_texts(), data.query_texts(n=40)
    p_enc = _text_encoder(lambda t, m: penc.encode(model, pc, t, m),
                          pmarco.simple_tokenizer, pc, 32)
    j_enc = _text_encoder(
        lambda t, m: jenc.encode(jparams, jc, jnp.asarray(t), jnp.asarray(m)),
        jmarco.simple_tokenizer, jc, 32)
    db = VectorDB("flat", metric="cosine", device="cpu").load_texts(
        passages, p_enc, batch_size=64)
    jdb = JaxVectorDB("flat", metric="cosine").load_texts(passages, j_enc,
                                                          batch_size=64)
    ps, pi, phits = db.query_texts(queries, p_enc, k=10)
    rs, ri, rhits = jdb.query_texts(queries, j_enc, k=10)
    ps, pi, rs, ri = ps.numpy(), pi.numpy(), np.asarray(rs), np.asarray(ri)
    np.testing.assert_allclose(ps, rs, atol=1e-5, rtol=1e-5)
    for r, j in zip(*np.nonzero(pi != ri)):
        where = np.flatnonzero(ri[r] == pi[r, j])
        other = rs[r, where[0]] if where.size else rs[r, -1]
        assert abs(other - ps[r, j]) <= 1e-5 + 1e-5 * abs(ps[r, j]), (r, j)
    assert phits == [[passages[j] for j in row] for row in pi.tolist()]
    assert len(rhits) == len(phits) == 40
    # a passage sent back as a query finds itself first
    s, i, _ = db.query_texts(passages[:20], p_enc, k=1)
    np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(20))


@pytest.mark.parametrize("entry", ["encode", "forward"])
@pytest.mark.parametrize("caller_flag", [True, False])
def test_bf16_reduction_flag_is_set_inside_and_restored(monkeypatch, entry,
                                                        caller_flag):
    """encode and the transformer forward sum bf16 products in float32
    whatever the caller set: the cuBLAS flag is off inside the call, and
    the caller's value is back after it, also when the call raises."""
    from repro_torch.models import transformer as ptr
    mm = torch.backends.cuda.matmul
    cfg = dataclasses.replace(pcfg.SMOKE, n_layers=1)
    model = penc.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(2, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    seen = []
    real_block = ptr._block_fwd

    def spy(*args, **kw):
        seen.append(mm.allow_bf16_reduced_precision_reduction)
        if len(seen) == 2:
            raise RuntimeError("raised inside the call")
        return real_block(*args, **kw)

    def call():
        if entry == "encode":
            return penc.encode(model, cfg, tokens, tokens != 0)
        return ptr.forward(model, cfg, tokens, kv_mask=tokens != 0)

    prev = mm.allow_bf16_reduced_precision_reduction
    monkeypatch.setattr(ptr, "_block_fwd", spy)
    try:
        mm.allow_bf16_reduced_precision_reduction = caller_flag
        call()
        assert mm.allow_bf16_reduced_precision_reduction is caller_flag
        with pytest.raises(RuntimeError, match="inside the call"):
            call()
        assert mm.allow_bf16_reduced_precision_reduction is caller_flag
    finally:
        mm.allow_bf16_reduced_precision_reduction = prev
    assert seen == [False, False]
