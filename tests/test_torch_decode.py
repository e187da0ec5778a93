"""The port's KV-cache decode path and serve launcher, held against the JAX
package's `models/decode.py` on the same numpy inputs, weights and caches.

The JAX weights cross with `convert.lm_params_from_numpy` and its caches
with `convert.lm_cache_from_numpy` (bf16 and f8 bits kept); tokens come
from numpy seeds.  Tolerances, the JAX package's own:

- decode logits: atol 1e-4 (tests/test_models_smoke.py:69, decode
  against the forward), caches 1e-5 (one f32 projection, then RoPE);
- attention_ref on the same operands: 1e-6 (the same arithmetic);
- the f8 cache: the JAX test's criteria (argmax equal to the forward's,
  correlation > 0.98, tests/test_models_smoke.py:105-122), and the port's
  f8 logits within 1e-2 of the JAX f8 logits (e4m3 roundings of K / V
  that fall apart where the f32 projections differ in their last bit).

Fault 3.6 (ROADMAP.md): with an f8 cache the port once cast q and the
probabilities to e4m3; it widens the cache to bf16 first now, as the
JAX `attention_ref` does.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.dist.sharding import ShardingRules
from repro.models import decode as jdec
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models.model import RunConfig as JRunConfig
from repro.models.model import forward as jforward
from repro.models.steps import build_serve_step as jbuild_serve_step
from _families import FAMILIES, frames, perturbed_params
from repro_torch.analysis import astlint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import decode as dec
from repro_torch.models import layers, steps
from repro_torch.models.model import RunConfig, forward

ROOT = Path(__file__).resolve().parents[1]
RULES = ShardingRules.null()
JRUN = JRunConfig(attn_impl="ref")
RUN = RunConfig("ref")
B, S = 2, 12
TOL_LOGITS, TOL_CACHE = 1e-4, 1e-5


def _tokens(cfg, seed, b=B, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=atol,
                               rtol=0)


def _carry(jcache):
    return lm_cache_from_numpy(jax.tree.map(np.asarray, jcache))


# ---------------------------------------------------------------------------
# fault 3.6: attention_ref over an f8 cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("q_dtype,cache_dtype", [
    (jnp.bfloat16, jnp.float8_e4m3fn),    # fault 3.6
    (jnp.float32, jnp.float32),
    (jnp.bfloat16, jnp.bfloat16),
], ids=["bf16_q_f8_cache", "f32", "bf16"])
def test_attention_ref_cache_dtypes_match_jax(q_dtype, cache_dtype):
    """q (2, 4, 1, 16) against a cache of 12 slots with 8 valid (numpy
    seed 0), on the same bits in both packages.  Before the repair the f8
    case was off by 0.047 on outputs of magnitude 1.36."""
    rs = np.random.RandomState(0)
    q = rs.randn(2, 4, 1, 16).astype(np.float32)
    k = rs.randn(2, 2, 12, 16).astype(np.float32)
    v = rs.randn(2, 2, 12, 16).astype(np.float32)
    valid = np.zeros((2, 12), bool)
    valid[:, :8] = True
    jq = jnp.asarray(q, q_dtype)
    jk, jv = jnp.asarray(k, cache_dtype), jnp.asarray(v, cache_dtype)
    t = lm_cache_from_numpy({"q": np.asarray(jq), "k": np.asarray(jk),
                             "v": np.asarray(jv)})
    want = jlayers.attention_ref(jq, jk, jv, causal=False,
                                 kv_valid=jnp.asarray(valid))
    got = layers.attention_ref(t["q"], t["k"], t["v"], causal=False,
                               kv_valid=torch.from_numpy(valid))
    assert got.dtype == t["q"].dtype
    _close(got, want, 1e-6)


def test_f8_cache_computes_in_bf16():
    k = torch.randn(1, 1, 4, 8)
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        assert layers._compute_dtype(k.to(dt)).dtype == torch.bfloat16
    for dt in (torch.float32, torch.bfloat16):
        assert layers._compute_dtype(k.to(dt)).dtype == dt


def test_cache_carries_narrow_bits_exactly():
    rs = np.random.RandomState(5)
    tree = {"k": np.asarray(jnp.asarray(rs.randn(2, 3), jnp.float8_e4m3fn)),
            "v": np.asarray(jnp.asarray(rs.randn(2, 3), jnp.float8_e5m2)),
            "w": np.asarray(jnp.asarray(rs.randn(2, 3), jnp.bfloat16)),
            "idx": np.asarray(jnp.asarray(7, jnp.int32))}
    got = lm_cache_from_numpy(tree)
    assert got["k"].dtype == torch.float8_e4m3fn
    assert got["v"].dtype == torch.float8_e5m2
    assert got["w"].dtype == torch.bfloat16
    for key, (tbits, nbits) in {"k": (torch.uint8, np.uint8),
                                "v": (torch.uint8, np.uint8),
                                "w": (torch.int16, np.int16)}.items():
        np.testing.assert_array_equal(got[key].view(tbits).numpy(),
                                      tree[key].view(nbits))
    assert got["idx"].dim() == 0 and int(got["idx"]) == 7


# ---------------------------------------------------------------------------
# the reduced presets
# ---------------------------------------------------------------------------
#: The dense presets and the VLM backbone; the other families have their
#: own fixture below (their caches hold other keys, and the ring cache is
#: an attention cache's).
DENSE = [a for a in ARCH_IDS if a not in FAMILIES]


@pytest.fixture(scope="module", params=DENSE)
def lm(request):
    """A reduced preset (f32), its JAX weights and the same weights in the
    port, and the JAX decode step compiled once."""
    jcfg = jget_config(request.param).reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    jstep = jax.jit(lambda p, c, t: jdec.decode_step(jcfg, p, c, t, RULES,
                                                     JRUN))
    return jcfg, get_config(request.param).reduced(), jp, tp, jstep


def _jprefill(jcfg, jp, toks, max_seq, vision=None, dtype=None):
    cache = jdec.init_cache(jcfg, toks.shape[0], max_seq, dtype=dtype)
    return jdec.prefill(jcfg, jp, jnp.asarray(toks), cache, RULES, JRUN,
                        vision_embeds=vision)


def test_prefill_matches_jax_prefill(lm):
    jcfg, cfg, jp, tp, _ = lm
    toks = _tokens(cfg, 0)
    want, jcache = _jprefill(jcfg, jp, toks, S + 4)
    cache = dec.init_cache(cfg, B, S + 4, device="cpu")
    got, out = dec.prefill(cfg, tp, torch.from_numpy(toks), cache)
    assert out is cache and got.shape == (B, cfg.vocab_size)
    _close(got, want, TOL_LOGITS)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], TOL_CACHE)
    assert cache["idx"].dim() == 0 and int(cache["idx"]) == S


def test_prefill_matches_forward(lm):
    """The serving invariant: decoding token by token against the cache
    gives the full forward's last logits."""
    _, cfg, _, tp, _ = lm
    toks = torch.from_numpy(_tokens(cfg, 1))
    cache = dec.start_cache(cfg, tp, B, S + 4)
    got, _ = dec.prefill(cfg, tp, toks, cache, RUN)
    want = forward(cfg, tp, toks, RUN)[:, -1]
    torch.testing.assert_close(got, want, atol=TOL_LOGITS, rtol=0)


def test_decode_and_serve_step_from_jax_cache(lm):
    """One step from a JAX cache carried across: logits, the greedy token
    and the updated cache match the JAX step's."""
    jcfg, cfg, jp, tp, jstep = lm
    toks = _tokens(cfg, 2)
    _, jcache = _jprefill(jcfg, jp, toks, S + 4)
    nxt = _tokens(cfg, 3, s=1)
    want, jnew = jstep(jp, jcache, jnp.asarray(nxt))
    jtok, _ = jax.jit(jbuild_serve_step(jcfg, RULES, JRUN))(
        jp, jcache, jnp.asarray(nxt, jnp.int32))

    cache = _carry(jcache)
    got, out = dec.decode_step(cfg, tp, cache, torch.from_numpy(nxt))
    assert out is cache
    _close(got, want, TOL_LOGITS)
    for key in ("k", "v"):
        _close(cache[key], jnew[key], TOL_CACHE)
    assert int(cache["idx"]) == int(jnew["idx"]) == S + 1

    tok, cache2 = steps.build_serve_step(cfg, RUN)(
        tp, _carry(jcache), torch.from_numpy(nxt).int())
    assert tok.shape == (B,) and tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _close(cache2["k"], jnew["k"], TOL_CACHE)


def test_ring_cache_matches_jax(lm):
    """A sliding window of 4 over S = 12 tokens: the ring wraps twice.
    Every step's logits against the JAX step's, the last against the
    port's windowed forward."""
    jcfg, cfg, jp, tp, _ = lm
    jcfg = dataclasses.replace(jcfg, sliding_window=4)
    cfg = dataclasses.replace(cfg, sliding_window=4)
    jstep = jax.jit(lambda p, c, t: jdec.decode_step(jcfg, p, c, t, RULES,
                                                     JRUN))
    toks = _tokens(cfg, 4)
    jcache = jdec.init_cache(jcfg, B, S)
    cache = dec.init_cache(cfg, B, S, device="cpu")
    assert cache["k"].shape[3] == dec.cache_len(cfg, S) == 4
    for t in range(S):
        want, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        got, cache = dec.decode_step(cfg, tp, cache,
                                     torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want, TOL_LOGITS)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], TOL_CACHE)
    full = forward(cfg, tp, torch.from_numpy(toks), RUN)[:, -1]
    torch.testing.assert_close(got, full, atol=TOL_LOGITS, rtol=0)


def test_generate_matches_jax(lm):
    jcfg, cfg, jp, tp, _ = lm
    prompt = _tokens(cfg, 5, s=8)
    want = jdec.generate(jcfg, jp, jnp.asarray(prompt, jnp.int32), 6, RULES,
                         JRUN)
    got = dec.generate(cfg, tp, torch.from_numpy(prompt).int(), 6, RUN)
    assert got.shape == (B, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cache_metadata_matches_jax(lm):
    jcfg, cfg, _, _, _ = lm
    assert dec.cache_axes(cfg) == jdec.cache_axes(jcfg)
    cache = dec.init_cache(cfg, 3, 20, device="cpu")
    jcache = jdec.init_cache(jcfg, 3, 20)
    assert set(cache) == set(jcache)
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape
    assert cache["k"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the f8 cache
# ---------------------------------------------------------------------------
def test_f8_cache_decode_close_to_forward_and_jax():
    """starcoder2-3b reduced, the JAX test's key and criteria."""
    jcfg = jget_config("starcoder2-3b").reduced()
    cfg = get_config("starcoder2-3b").reduced()
    key = jax.random.PRNGKey(7)
    jp = jinit_params(jcfg, key)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = np.array(jax.random.randint(key, (B, S), 0, cfg.vocab_size))
    want, jcache = _jprefill(jcfg, jp, toks, S + 2,
                             dtype=jnp.float8_e4m3fn)
    cache = dec.init_cache(cfg, B, S + 2, dtype=torch.float8_e4m3fn,
                           device="cpu")
    got, cache = dec.prefill(cfg, tp, torch.from_numpy(toks), cache)
    assert cache["k"].dtype == torch.float8_e4m3fn
    ref = forward(cfg, tp, torch.from_numpy(toks), RUN)[:, -1]
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    corr = np.corrcoef(got.numpy().ravel(), ref.numpy().ravel())[0, 1]
    assert corr > 0.98, corr
    _close(got, want, 1e-2)


# ---------------------------------------------------------------------------
# the VLM backbone
# ---------------------------------------------------------------------------
def test_apply_mrope_matches_jax():
    rs = np.random.RandomState(8)
    x = rs.randn(2, 4, 12, 16).astype(np.float32)
    pos = rs.randint(0, 50, (2, 3, 12))
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (2, 3, 3),
                               1e4)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             (2, 3, 3), 1e4)
    _close(got, want, 1e-6)
    with pytest.raises(ValueError, match="half the head dim"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                           (2, 3, 2))


@pytest.fixture(scope="module")
def vlm():
    jcfg = jget_config("qwen2-vl-2b").reduced()
    cfg = get_config("qwen2-vl-2b").reduced()
    jp = jinit_params(jcfg, jax.random.PRNGKey(2))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    vision = np.random.RandomState(9).randn(
        B, cfg.n_vision_tokens, cfg.d_model).astype(np.float32)
    return jcfg, cfg, jp, tp, vision


def test_vlm_forward_with_vision_embeds_matches_jax(vlm):
    jcfg, cfg, jp, tp, vision = vlm
    assert cfg.mrope_sections == (2, 3, 3) and cfg.n_vision_tokens == 8
    toks = _tokens(cfg, 10)
    want = jforward(jcfg, jp, jnp.asarray(toks), RULES, JRUN,
                    vision_embeds=jnp.asarray(vision))
    got = forward(cfg, tp, torch.from_numpy(toks), RUN,
                  vision_embeds=torch.from_numpy(vision))
    _close(got, want, TOL_LOGITS)
    text = forward(cfg, tp, torch.from_numpy(toks), RUN)
    assert float((got - text).abs().max()) > 1e-3   # the embeds count


def test_vlm_prefill_with_vision_embeds_matches_jax(vlm):
    jcfg, cfg, jp, tp, vision = vlm
    toks = _tokens(cfg, 11)
    want, jcache = _jprefill(jcfg, jp, toks, S + 4,
                             vision=jnp.asarray(vision))
    cache = dec.init_cache(cfg, B, S + 4, device="cpu")
    got, cache = dec.prefill(cfg, tp, torch.from_numpy(toks), cache,
                             vision_embeds=torch.from_numpy(vision))
    _close(got, want, TOL_LOGITS)
    _close(cache["k"], jcache["k"], TOL_CACHE)
    full = forward(cfg, tp, torch.from_numpy(toks), RUN,
                   vision_embeds=torch.from_numpy(vision))[:, -1]
    torch.testing.assert_close(got, full, atol=TOL_LOGITS, rtol=0)


# ---------------------------------------------------------------------------
# the other families: MoE, MLA, RWKV6, hymba, whisper
# ---------------------------------------------------------------------------
def _no_drop(cfg):
    """The MoE capacity factor at which `capacity` returns every token, so
    that a forward over B * S tokens and a decode step over B drop alike
    (none): n_experts / top_k (the JAX tests run 8.0 at this size)."""
    return cfg.n_experts / cfg.top_k if cfg.n_experts else None


@pytest.fixture(scope="module", params=FAMILIES)
def family_lm(request):
    """A reduced family preset (f32), its perturbed JAX weights and the
    same weights in the port, whisper's encoder frames, the run configs
    at the no-drop capacity factor and the JAX decode step compiled
    once."""
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp, tp = perturbed_params(jcfg, 11)
    jfr, tfr = frames(cfg, 12, B)
    jrun = JRunConfig(attn_impl="ref", moe_capacity_factor=_no_drop(cfg))
    run = RunConfig("ref", moe_capacity_factor=_no_drop(cfg))
    jstep = jax.jit(lambda p, c, t: jdec.decode_step(jcfg, p, c, t, RULES,
                                                     jrun))
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, jfr=jfr, tfr=tfr,
                jrun=jrun, run=run, jstep=jstep)


def _jfamily_prefill(f, toks, max_seq):
    cache = jdec.start_cache(f["jcfg"], f["jp"], toks.shape[0], max_seq,
                             RULES, f["jrun"], **f["jfr"])
    return jdec.prefill(f["jcfg"], f["jp"], jnp.asarray(toks), cache, RULES,
                        f["jrun"])


def _close_caches(cache, jcache):
    assert set(cache) == set(jcache)
    for key in cache:
        if key != "idx":
            assert cache[key].dtype == torch.float32, key
            _close(cache[key], jcache[key], TOL_CACHE)
    assert int(cache["idx"]) == int(jcache["idx"])


def test_family_prefill_matches_jax_prefill(family_lm):
    f = family_lm
    cfg = f["cfg"]
    toks = _tokens(cfg, 13)
    want, jcache = _jfamily_prefill(f, toks, S + 4)
    cache = dec.start_cache(cfg, f["tp"], B, S + 4, f["run"], **f["tfr"])
    got, out = dec.prefill(cfg, f["tp"], torch.from_numpy(toks), cache,
                           f["run"])
    assert out is cache and got.shape == (B, cfg.vocab_size)
    _close(got, want, TOL_LOGITS)
    _close_caches(cache, jcache)
    assert int(cache["idx"]) == S


def test_family_prefill_matches_forward(family_lm):
    """The serving invariant on the port alone: token by token against
    the cache gives the forward's logits at every position."""
    f = family_lm
    cfg = f["cfg"]
    toks = torch.from_numpy(_tokens(cfg, 14))
    full = forward(cfg, f["tp"], toks, f["run"], **f["tfr"])
    cache = dec.start_cache(cfg, f["tp"], B, S + 4, f["run"], **f["tfr"])
    for t in range(S):
        got, cache = dec.decode_step(cfg, f["tp"], cache, toks[:, t:t + 1],
                                     f["run"])
        torch.testing.assert_close(got, full[:, t], atol=TOL_LOGITS, rtol=0)


def test_family_decode_and_serve_step_from_jax_cache(family_lm):
    """One step from a JAX cache carried across (`lm_cache_from_numpy`):
    logits, the greedy token and every updated cache entry match the JAX
    step's."""
    f = family_lm
    cfg = f["cfg"]
    _, jcache = _jfamily_prefill(f, _tokens(cfg, 15), S + 4)
    nxt = _tokens(cfg, 16, s=1)
    want, jnew = f["jstep"](f["jp"], jcache, jnp.asarray(nxt))
    jtok, _ = jax.jit(jbuild_serve_step(f["jcfg"], RULES, f["jrun"]))(
        f["jp"], jcache, jnp.asarray(nxt, jnp.int32))
    cache = _carry(jcache)
    got, out = dec.decode_step(cfg, f["tp"], cache, torch.from_numpy(nxt),
                               f["run"])
    assert out is cache
    _close(got, want, TOL_LOGITS)
    _close_caches(cache, jnew)
    tok, _ = steps.build_serve_step(cfg, f["run"])(
        f["tp"], _carry(jcache), torch.from_numpy(nxt).int())
    assert tok.shape == (B,) and tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_family_generate_matches_jax(family_lm):
    f = family_lm
    prompt = _tokens(f["cfg"], 17, s=8)
    want = jdec.generate(f["jcfg"], f["jp"], jnp.asarray(prompt, jnp.int32),
                         6, RULES, f["jrun"], **f["jfr"])
    got = dec.generate(f["cfg"], f["tp"], torch.from_numpy(prompt).int(), 6,
                       f["run"], **f["tfr"])
    assert got.shape == (B, 6) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_family_cache_metadata_matches_jax(arch, dtype):
    """Keys, axes, shapes and dtypes of the reduced cache in an f32 and a
    bf16 model (recurrent states stay f32 where JAX keeps them f32)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    assert dec.cache_axes(cfg) == jdec.cache_axes(jcfg)
    cache = dec.init_cache(cfg, 3, 20, device="cpu")
    jcache = jdec.init_cache(jcfg, 3, 20)
    assert set(cache) == set(jcache)
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        assert str(cache[key].dtype).split(".")[-1] == \
            str(jcache[key].dtype), key


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-1.6b"])
def test_subquadratic_cache_stays_small(arch):
    """The JAX test's criterion (tests/test_models_smoke.py:78-95): at
    max_seq = 2**20 the cache is under 1% of a full KV cache, and a serve
    step runs from it."""
    cfg = get_config(arch).reduced()
    cache = dec.init_cache(cfg, 2, max_seq=1 << 20, device="cpu")
    total = sum(t.numel() * t.element_size() for t in cache.values())
    full_kv = cfg.n_layers * 2 * 2 * cfg.n_kv_heads * (1 << 20) * cfg.hd
    assert total < full_kv / 100
    tp = perturbed_params(jget_config(arch).reduced(), 18)[1]
    nxt, out = steps.build_serve_step(cfg)(tp, cache,
                                           torch.zeros(2, 1, dtype=torch.int32))
    assert out is cache and nxt.shape == (2,) and int(cache["idx"]) == 1


def test_whisper_needs_encoder_frames():
    cfg = get_config("whisper-large-v3").reduced()
    tp = perturbed_params(jget_config("whisper-large-v3").reduced(), 19)[1]
    with pytest.raises(ValueError, match="encoder frames"):
        dec.start_cache(cfg, tp, B, 8)
    assert int(dec.init_cache(cfg, B, 8, device="cpu")["xk"].abs().max()) == 0


# ---------------------------------------------------------------------------
# device rules, families, the launcher and the lint
# ---------------------------------------------------------------------------
def test_cache_device_rules():
    cfg = get_config("qwen1.5-4b").reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dec.init_cache(cfg, 2, 8)
    tp = lm_params_from_numpy(jax.tree.map(
        np.asarray, jinit_params(jget_config("qwen1.5-4b").reduced(),
                                 jax.random.PRNGKey(4))))
    cache = dec.start_cache(cfg, tp, 2, 8)
    idx = cache["idx"]
    assert idx.device.type == "cpu" and idx.dim() == 0
    for _ in range(3):
        _, cache = dec.decode_step(cfg, tp, cache,
                                   torch.zeros(2, 1, dtype=torch.long))
    assert cache["idx"] is idx and idx.dim() == 0 and int(idx) == 3
    assert idx.device == cache["k"].device


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen2-vl-2b",
                                  "whisper-large-v3", "rwkv6-1.6b"])
def test_serve_launcher_runs_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--batch", "2",
                       "--prompt-len", "10", "--gen", "4", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[1] for line in out] == ["batch=2", "prefill",
                                                 "sample"]


def test_decode_reads_no_device_value_on_the_host():
    """models/decode.py held to the host-sync rule as library code (as a
    scaffold module the lint would skip it)."""
    findings = astlint.lint_file(
        str(ROOT / "src" / "repro_torch" / "models" / "decode.py"))
    assert findings == [], findings


@pytest.mark.parametrize("module", ["moe", "rwkv6", "mamba"])
def test_family_modules_read_no_device_value_on_the_host(module):
    """The modules a decode step runs for the MoE, RWKV6 and hymba, held
    to the same rule."""
    findings = astlint.lint_file(
        str(ROOT / "src" / "repro_torch" / "models" / f"{module}.py"))
    assert findings == [], findings
