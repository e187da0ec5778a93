"""The port's LM forward (every preset) and its flash-attention plain
version, held against the JAX package on the same
numpy inputs and weights.

Tolerances, each the JAX package's own for the same function:
- flash attention: f32 2e-5, bf16 2e-2 (tests/test_kernels.py:69), the
  JAX kernel run in Pallas interpret mode;
- the layer functions: f32 1e-6 (both sides are the same f32 arithmetic);
- the reduced forward: logits atol 1e-4 in f32 (two layers, f32 matmuls in
  another summation order), the JAX side with ``attn_impl="flash"`` in
  interpret mode, the port on the JAX weights carried across by
  `convert.lm_params_from_numpy`.

The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _families import frames
from repro.configs import get_config as jget_config
from repro.dist.sharding import ShardingRules
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models.model import RunConfig as JRunConfig
from repro.models.model import forward as jforward
from repro.models.model import lm_loss as jlm_loss
from repro.models.params import abstract_params as jabstract_params
from repro.models.params import count_params as jcount_params
from repro.models.steps import build_loss_fn as jbuild_loss_fn
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (FFMA_WIDTHS,
                                                 ffma_width,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import layers, steps
from repro_torch.models.model import RunConfig, forward, lm_loss
from repro_torch.models.params import (abstract_params, count_params,
                                       init_params)

RULES = ShardingRules.null()
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-5),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)}


def _randn(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(a, dtype):
    """The same values in both packages, rounded to `dtype` the same way."""
    _, jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 2, 128, 64),
    (2, 4, 2, 256, 64),    # GQA
    (1, 8, 1, 256, 128),   # MQA
    (1, 4, 2, 128, 80),    # head dims the FFMA kernel pads to 128 / 256
    (1, 4, 2, 128, 96),
    (1, 4, 2, 128, 256),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_matches_jax_kernel(b, hq, hkv, s, d, causal, dtype):
    """The shapes of tests/test_kernels.py:55-59, and head dims that are
    not a power of two or reach 256, which the JAX kernel takes too."""
    tol = DTYPES[dtype][3]
    qj, qt = _both(_randn(0, (b, hq, s, d)), dtype)
    kj, kt = _both(_randn(1, (b, hkv, s, d)), dtype)
    vj, vt = _both(_randn(2, (b, hkv, s, d)), dtype)
    want = jflash(qj, kj, vj, causal=causal, block_q=128, block_k=128,
                  interpret=True)
    got = flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True), (100, 100, False),
                                          (64, 100, True), (100, 37, False)])
def test_flash_plain_ragged_matches_attention_ref(sq, sk, causal):
    """Any Sq and Sk (the TPU kernel asks for multiples of 128): held to
    the kernel's oracle `kernels/ref.py::attention_ref` (top-left mask)."""
    q, k, v = (_randn(3, (2, 4, sq, 32)), _randn(4, (2, 2, sk, 32)),
               _randn(5, (2, 2, sk, 32)))
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, scale=0.3)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("d,width", [
    (1, 16), (3, 16), (16, 16), (17, 32), (20, 32), (32, 32), (33, 64),
    (64, 64), (80, 128), (96, 128), (128, 128), (129, 256), (200, 256),
    (256, 256)])
def test_ffma_width_rule(d, width):
    """The FFMA kernel runs head dim d on the smallest instantiated width
    that holds it."""
    assert ffma_width(d) == width


def test_ffma_width_covers_every_head_dim_to_256():
    for d in range(1, 257):
        w = ffma_width(d)
        assert w in FFMA_WIDTHS and w >= d
        assert all(x < d for x in FFMA_WIDTHS if x < w)


@pytest.mark.parametrize("d", [0, -1, 257, 512])
def test_ffma_width_rejects_head_dims_outside_1_to_256(d):
    with pytest.raises(ValueError, match="head dims 1 to 256"):
        ffma_width(d)


def test_flash_rejects_what_it_does_not_take():
    q = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="key"):
        flash_attention(q, torch.zeros(1, 3, 0, 16), torch.zeros(1, 3, 0, 16))
    meta = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(meta, meta, meta)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-7b"])
def test_tensor_core_flash_reads_lm_head_views_in_place(arch):
    """The head-split views of the fused QKV projection (head stride hd,
    below the seq stride) meet TMA's rules as they are, so the bf16
    tensor-core kernel reads them with no copy; views that start off 16
    bytes or have a strided last axis do not."""
    from repro_torch.kernels.flash_attention import _tma_ready
    from repro_torch.models import model as tmodel

    cfg = get_config(arch)
    width = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    p = {"wqkv": torch.zeros(cfg.d_model, width, dtype=torch.bfloat16),
         "bqkv": torch.zeros(width, dtype=torch.bfloat16)}
    x = torch.zeros(2, 16, cfg.d_model, dtype=torch.bfloat16)
    q, k, v = tmodel._qkv(cfg, x, p)
    assert q.shape[1:] == (cfg.n_heads, 16, 128)
    assert q.stride(1) < q.stride(2)           # heads inside a token
    assert all(_tma_ready(t) for t in (q, k, v))
    flat = torch.zeros(2 * 16 * 2 * cfg.hd + 4, dtype=torch.bfloat16)
    shifted = flat[1:1 + q.numel() // cfg.n_heads * 2].view(2, 2, 16, cfg.hd)
    assert not _tma_ready(shifted)                       # 2-byte start
    assert not _tma_ready(q[..., 1:cfg.hd - 7])          # 2-byte start
    assert not _tma_ready(q.transpose(2, 3))             # D not contiguous


# ---------------------------------------------------------------------------
# layer functions
# ---------------------------------------------------------------------------
def _layer_cases():
    x = _randn(10, (2, 5, 64))
    w = _randn(11, (64,))
    bias = _randn(12, (64,))
    heads = _randn(13, (2, 4, 12, 16))
    pos = np.broadcast_to(np.arange(3, 15), (2, 12)).copy()
    q, k, v = (_randn(14, (2, 4, 12, 16)), _randn(15, (2, 2, 20, 16)),
               _randn(16, (2, 2, 20, 16)))
    valid = np.random.RandomState(17).rand(2, 20) > 0.3
    qc = _randn(18, (1, 4, 64, 16))
    kc, vc = _randn(19, (1, 2, 64, 16)), _randn(20, (1, 2, 64, 16))
    wg, wu = _randn(21, (64, 96)) * 0.1, _randn(22, (64, 96)) * 0.1
    wd, wb = _randn(23, (96, 64)) * 0.1, _randn(24, (96,))
    return {
        "rms_norm": ("rms_norm", (x, w), {}),
        "layer_norm": ("layer_norm", (x, w, bias), {}),
        "rope_freqs": ("rope_freqs", (16, 500.0), {}),
        "apply_rope": ("apply_rope", (heads, pos, 1e4), {}),
        "attention_ref_causal": ("attention_ref", (q, k, v), {}),
        "attention_ref_window": ("attention_ref", (q, k, v),
                                 {"window": 5, "scale": 0.2}),
        "attention_ref_kv_valid": ("attention_ref", (q, k, v),
                                   {"causal": False, "kv_valid": valid}),
        "attention_chunked": ("attention_chunked", (qc, kc, vc),
                              {"chunk": 16}),
        "attention_chunked_window": ("attention_chunked", (qc, kc, vc),
                                     {"chunk": 16, "window": 9}),
        "ffn_swiglu": ("ffn_swiglu", (x, wg, wu, wd), {}),
        "ffn_gelu": ("ffn_gelu", (x, wg, wb, wd, w), {}),
    }


@pytest.mark.parametrize("case", list(_layer_cases()))
def test_layer_functions_match_jax(case):
    name, args, kw = _layer_cases()[case]

    def conv(a, to):
        if isinstance(a, np.ndarray):
            return jnp.asarray(a) if to == "jax" else torch.from_numpy(a)
        return a

    want = getattr(jlayers, name)(*(conv(a, "jax") for a in args),
                                  **{k: conv(v, "jax") for k, v in kw.items()})
    got = getattr(layers, name)(*(conv(a, "torch") for a in args),
                                **{k: conv(v, "torch") for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_attention_ref_bf16_operands_match_jax():
    """bf16 operands with f32 accumulation, probabilities cast to bf16."""
    qj, qt = _both(_randn(30, (1, 4, 16, 16)), "bf16")
    kj, kt = _both(_randn(31, (1, 2, 16, 16)), "bf16")
    vj, vt = _both(_randn(32, (1, 2, 16, 16)), "bf16")
    want = jlayers.attention_ref(qj, kj, vj)
    got = layers.attention_ref(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("impl,kw,flash", [
    ("flash", {}, True),
    ("flash", {"window": 4}, False),
    ("flash", {"kv_valid": torch.ones(1, 16, dtype=torch.bool)}, False),
    ("chunked", {}, False),
    ("ref", {}, False),
])
def test_attention_dispatch_rule(monkeypatch, impl, kw, flash):
    """The flash kernel runs exactly under the JAX package's conditions
    (models/layers.py:198-208)."""
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return flash_attention_plain(*a, **k)

    monkeypatch.setattr(ops, "flash_attention", spy)
    q = torch.from_numpy(_randn(40, (1, 2, 16, 16)))
    k = torch.from_numpy(_randn(41, (1, 2, 16, 16)))
    out = layers.attention(q, k, k, impl=impl, **kw)
    assert out.shape == q.shape
    assert bool(calls) == flash


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_tree_matches_jax(arch):
    """Same keys, shapes and init rules as the JAX package's tree, at the
    preset's full width (metadata only)."""
    cfg = get_config(arch)
    jt = jabstract_params(jget_config(arch))
    tt = abstract_params(cfg)

    def flat(tree, prefix=""):
        for key, val in tree.items():
            if isinstance(val, dict):
                yield from flat(val, prefix + key + "/")
            else:
                yield prefix + key, (tuple(val.shape), tuple(val.axes),
                                     val.init, val.scale)

    assert dict(flat(tt)) == dict(flat(jt))
    assert count_params(cfg) == jcount_params(jget_config(arch))
    assert cfg.param_count() == jget_config(arch).param_count()


def test_init_params_rule_and_device():
    cfg = get_config("starcoder2-3b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = init_params(cfg, gen, device="cpu")
    assert p["layers"]["wqkv"].shape == (2, 64, (4 + 2 * 2) * 16)
    assert p["layers"]["wqkv"].dtype == torch.float32
    assert float(p["layers"]["bqkv"].abs().max()) == 0.0
    assert bool((p["layers"]["norm1"] == 1).all())
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"], p["embed"])
    bf = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.bfloat16)
    assert bf["lm_head"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_params(cfg, gen)


def test_convert_carries_bf16_bits():
    cfg = jget_config("deepseek-7b").reduced()
    jp = jinit_params(dataclasses.replace(cfg, dtype="bfloat16"),
                      jax.random.PRNGKey(3))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    assert tp["layers"]["w_gu"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["layers"]["w_gu"].float().numpy(),
        np.asarray(jp["layers"]["w_gu"], np.float32))


def test_train_and_serve_steps_name_their_roadmap_item():
    """Both steps are ported and run (tests/test_torch_train.py and
    tests/test_torch_decode.py hold them against JAX), for the dense
    family and, since the other families were ported, an RWKV6 mixer
    too."""
    from repro_torch.models import decode
    from repro_torch.optim import adamw_init

    cfg = get_config("starcoder2-3b").reduced()
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    rcfg = dataclasses.replace(cfg, mixer="rwkv6")
    rparams = init_params(rcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    rparams, _, m = steps.build_train_step(rcfg, lr=1e-3)(
        rparams, adamw_init(rparams), {"tokens": toks, "labels": toks})
    assert "w_dd1" in rparams["layers"] and "wqkv" not in rparams["layers"]
    assert int(m["step"]) == 1 and bool(torch.isfinite(m["loss"]))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {k: t.clone() for k, t in params["layers"].items()}
    params, state, m = steps.build_train_step(cfg, lr=1e-3)(
        params, adamw_init(params), {"tokens": toks, "labels": toks})
    assert int(m["step"]) == 1 and bool(torch.isfinite(m["loss"]))
    assert float(m["grad_norm"]) > 0
    assert all(not torch.equal(before[k], t)
               for k, t in params["layers"].items())
    cache = decode.init_cache(cfg, 2, 4, device="cpu")
    tok = torch.zeros(2, 1, dtype=torch.int32)
    nxt, out = steps.build_serve_step(cfg)(params, cache, tok)
    assert out is cache and int(cache["idx"]) == 1
    assert nxt.shape == (2,) and nxt.dtype == torch.int32
    assert bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all())


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCH_IDS)
def reduced_lm(request):
    """A reduced preset, its JAX weights and the same weights in the
    port."""
    jcfg = jget_config(request.param).reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, get_config(request.param).reduced(), jp, tp


def _tokens(cfg, seed, B, S):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, S))


def test_forward_flash_matches_jax_flash(reduced_lm):
    """B = 2, S = 128: the JAX side through its Pallas flash kernel in
    interpret mode, the port through the flash kernel's plain version.
    Whisper's encoder reads 128 frames (the JAX kernel takes multiples of
    128 only): its encoder, decoder and cross-attention all go through
    the kernel."""
    jcfg, cfg, jp, tp = reduced_lm
    toks = _tokens(cfg, 0, 2, 128)
    jfr, tfr = frames(cfg, 4, 2, 128)
    want = jforward(jcfg, jp, jnp.asarray(toks), RULES,
                    JRunConfig(attn_impl="flash"), **jfr)
    got = forward(cfg, tp, torch.from_numpy(toks), RunConfig("flash"), **tfr)
    assert got.shape == (2, 128, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(
        float(lm_loss(got, torch.from_numpy(toks))),
        float(jlm_loss(want, jnp.asarray(toks))), atol=1e-4)


@pytest.mark.parametrize("impl", ["flash", "chunked", "ref"])
def test_forward_ragged_matches_jax_ref(reduced_lm, impl):
    """S = 100, which the TPU flash kernel does not take: every port
    attention implementation against the JAX ``attn_impl="ref"``."""
    jcfg, cfg, jp, tp = reduced_lm
    toks = _tokens(cfg, 1, 2, 100)
    jfr, tfr = frames(cfg, 5, 2)
    want = jforward(jcfg, jp, jnp.asarray(toks), RULES,
                    JRunConfig(attn_impl="ref"), **jfr)
    got = forward(cfg, tp, torch.from_numpy(toks), RunConfig(impl), **tfr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_loss_fn_matches_jax(reduced_lm):
    jcfg, cfg, jp, tp = reduced_lm
    toks = _tokens(cfg, 2, 2, 64)
    labels = _tokens(cfg, 3, 2, 64)
    jfr, tfr = frames(cfg, 6, 2)
    want = jbuild_loss_fn(jcfg, RULES, JRunConfig(attn_impl="chunked",
                                                  attn_chunk=16))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             **jfr})
    got = steps.build_loss_fn(cfg, RunConfig("chunked", attn_chunk=16))(
        tp, {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels), **tfr})
    assert abs(float(got) - float(want)) < 1e-4
